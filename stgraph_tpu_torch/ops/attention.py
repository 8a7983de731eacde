"""GAT's segment-softmax attention: the dense path for small graphs, and the
sparse path (flash-GAT's kernels, or the composed route) for large ones.

Counterpart of ``stgraph_tpu/ops/attention.py``:

  * ``dense_gat_attention`` (``:56-110``): per head, the (N, N) scores
    ``leaky(el[s] + er[d])`` masked by edge counts, softmax-normalised per
    destination row and applied as one matmul. Heads run one at a time to
    bound the N^2 temporary. Duplicate edges count with their multiplicity;
    rows without edges come out as exactly 0.
  * ``sparse_gat_attention`` (``:113-359``) routes by the tiling alone:
    the flash route (``ops.flash_gat``: K4 and K8 forward, K9 backward)
    whenever ``flash_supported``; else the composed route's rowmask branch,
    ``RowmaskGat`` (the JAX custom VJP's ``use_rowmask`` branch,
    ``:197-200, 236-256, 287-325``), for the tilings the row-wise kernel
    takes (``rowmask_eligible``): the stability max, K1's heads and
    denominator modes forward, K2's heads mode and two segment sums
    backward; else ``ComposedGat``, the non-rowmask branch (``:225-280``
    forward, ``:282-352`` backward) over the blocked kernel K10.
  * The segment reductions of both composed branches (``_segment``) are
    the narrow kernels K4 (max) and K3 (sum) up to 16 heads, and K5 and
    K1's no-gather mode (``segment_sum_wide``) past 16.

Every tiling runs on CUDA. On the CPU the same functions run the kernels'
plain versions.

Attention dropout: ``sparse_gat_attention`` takes it on the flash route
only, inside K8 and K9 (the stateless ``flash_gat.edge_keep_mask`` hash,
JAX's ``:115-188``); ``composed_gat_attention_dropout`` is the edge-domain
route, plain torch, with a mask drawn by ``torch.rand`` or given as a
precomputed plane (the same hash, where ``GATConv`` wants the reference's
flash mask at a tiling past the port's flash kernels).
"""

from __future__ import annotations

from typing import Optional

import torch

from stgraph_tpu_torch.graph.blocked import BlockedCSR
from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import message as M
from stgraph_tpu_torch.ops import segment as seg
from stgraph_tpu_torch.ops.flash_gat import flash_gat_attention, flash_supported
from stgraph_tpu_torch.ops.segment_kernels import (
    MAX_NARROW_K,
    segment_max_narrow,
    segment_max_wide,
    segment_sum_narrow,
    segment_sum_wide,
)
from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd
from stgraph_tpu_torch.ops.spmm_blocked import (
    _ensure_blocked,
    _to_blocked_w_mh,
    per_head_sddmm,
    positions_in,
    rowmask_eligible,
    segment_sum_blocked,
)

__all__ = [
    "ComposedGat",
    "RowmaskGat",
    "composed_gat_attention_dropout",
    "dense_gat_attention",
    "flash_path_available",
    "flash_supported",
    "sparse_gat_attention",
]

_TINY = torch.finfo(torch.float32).tiny


def flash_path_available(csr: CSR, heads: int, f: int) -> bool:
    """True when ``sparse_gat_attention`` takes the flash route: the tiling
    is the Hopper kernels' (``flash_supported``: ``heads <= 16`` and
    ``heads * f <= 256``). The kernels run on CUDA, and their plain versions
    on the CPU; the plane size never limits them (no plane is built)."""
    return flash_supported(heads, f)


def _dense_counts(csr: CSR) -> torch.Tensor:
    """(N, N) f32 edge-count matrix ``A[d, s]``, built once per CSR."""

    def make():
        n = csr.num_nodes
        mask = csr.edge_mask
        flat = csr.rows_clamped.long()[mask] * n + csr.cols_clamped.long()[mask]
        counts = torch.zeros(n * n, dtype=torch.float32, device=csr.device)
        return counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32)).reshape(n, n)

    return csr.cached("dense_counts", make)


def dense_gat_attention(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    feat_src: torch.Tensor,
    negative_slope: float = 0.2,
    attn_drop_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """``out[d, h] = sum_s softmax_s(leaky(el[s, h] + er[d, h])) * feat[s, h]``.

    ``el``, ``er`` are (N, H, 1) and ``feat_src`` (N, H, F), as in the JAX
    package. ``attn_drop_rate > 0`` drops entries of the NORMALISED
    coefficients (DGL semantics) per (dst, src, head), with the 1/(1-p)
    rescale of the kept ones, drawing from ``generator``.
    """
    counts = _dense_counts(csr)
    el2, er2 = el[..., 0], er[..., 0]
    neg = torch.finfo(torch.float32).min
    outs = []
    for h in range(el2.shape[1]):
        s = el2[None, :, h] + er2[:, h, None]  # (N_dst, N_src)
        s = torch.where(s >= 0, s, negative_slope * s)
        # The max and the exp use the masked scores: a non-edge score above
        # the neighbours' max would overflow exp, and an edgeless row must
        # come out as 0 (counts 0 times exp(0)), not NaN.
        masked = torch.where(counts > 0, s, torch.full((), neg, dtype=s.dtype, device=s.device))
        m = masked.amax(dim=1, keepdim=True)
        e = counts * torch.exp(masked - m)
        alpha = e / e.sum(dim=1, keepdim=True).clamp(min=_TINY)
        if attn_drop_rate > 0.0:
            keep = torch.rand(alpha.shape, generator=generator, device=alpha.device) < 1.0 - attn_drop_rate
            alpha = torch.where(keep, alpha / (1.0 - attn_drop_rate), torch.zeros((), device=alpha.device))
        outs.append((alpha @ feat_src[:, h].float()).to(feat_src.dtype))
    return torch.stack(outs, dim=1)


def _segment(csr: CSR, vals: torch.Tensor, reduce: str) -> torch.Tensor:
    """K4 (``max``) or K3 (``sum``) of a (capacity, H) plane, and K5 or K1's
    no-gather mode (``segment_sum_wide``) past ``MAX_NARROW_K`` heads, as
    the JAX package's ``aggregate`` sends them on its TPU."""
    if vals.shape[1] <= MAX_NARROW_K:
        return (segment_max_narrow if reduce == "max" else segment_sum_narrow)(csr, vals)
    return (segment_max_wide if reduce == "max" else segment_sum_wide)(csr, vals)


def _leaky(s0: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(s0 >= 0, s0, slope * s0)


class ComposedGat(torch.autograd.Function):
    """The composed route with the JAX package's hand-derived backward.

    Forward, with ``s = leaky(el[src] + er[dst])`` per edge and head:
    ``m = max_dst s`` (K4), ``w = exp(s - m[dst])``, ``den = sum_dst w``
    (K3), ``out = K10(w, feat) / den``. Backward, for a cotangent ``g`` of
    ``out``: ``gu = g / den`` and the node-wise ``c = <g, out> / den``;
    ``d feat`` by K10 on the transpose layout with ``w``; ``dw = <feat[src],
    gu[dst]>`` per head; ``ds0 = w (dw - c[dst]) leaky'(s0)``; ``d er`` by K3
    on the forward CSR and ``d el`` by K3 on the transpose CSR with
    ``ds0[perm_t]``. ``d m = 0``: the softmax is invariant to the shift.
    """

    @staticmethod
    def forward(ctx, el2, er2, fs, csr, csr_t, blocked, blocked_t, slope):
        n, h, f = fs.shape
        rows, cols = csr.rows_clamped, csr.cols_clamped  # int32 gathers: no (capacity,) int64 copies
        s0 = el2.index_select(0, cols) + er2.index_select(0, rows)
        s = torch.where(s0 >= 0, s0, slope * s0)
        m = _segment(csr, s, "max")
        w = torch.exp(s - m.index_select(0, rows))
        w = torch.where(csr.edge_mask[:, None], w, torch.zeros((), device=w.device))
        denom = _segment(csr, w, "sum").clamp(min=_TINY)
        # aggregate with the unnormalised weights and divide at node level
        u = segment_sum_blocked(blocked, _to_blocked_w_mh(blocked, csr, w), fs.reshape(n, h * f), h)
        out = u.reshape(n, h, f) / denom[:, :, None]
        ctx.graph = (csr, csr_t, blocked_t, slope)
        ctx.save_for_backward(el2, er2, fs, denom, out, w)
        return out

    @staticmethod
    def backward(ctx, g):
        el2, er2, fs, denom, out, w = ctx.saved_tensors
        csr, csr_t, blocked_t, slope = ctx.graph
        n, h, f = fs.shape
        g = g.float()
        gu = (g / denom[:, :, None]).reshape(n, h * f)
        c = (g * out).sum(-1) / denom
        dfs = segment_sum_blocked(blocked_t, _to_blocked_w_mh(blocked_t, csr, w), gu, h)
        dw = per_head_sddmm(csr, fs.reshape(n, h * f), gu, h)
        rows, cols = csr.rows_clamped, csr.cols_clamped
        s0 = el2.index_select(0, cols) + er2.index_select(0, rows)
        ds0 = w * (dw - c.index_select(0, rows)) * torch.where(s0 >= 0, 1.0, slope)
        der = _segment(csr, ds0, "sum")
        dl = _segment(csr_t, ds0.index_select(0, positions_in(csr, csr_t.eids)), "sum")
        return dl.to(el2.dtype), der.to(er2.dtype), dfs.reshape(n, h, f).to(fs.dtype), None, None, None, None, None


class RowmaskGat(torch.autograd.Function):
    """The composed route's rowmask branch with the JAX package's
    hand-derived backward (``stgraph_tpu/ops/attention.py:236-256`` forward,
    ``:287-325`` backward), in the same order and the same edge orders.

    Forward, with ``s = leaky(el[src] + er[dst])`` per edge and head (CSR
    order): ``m = max_dst s`` (``_segment``: K4, or K5 past 16 heads),
    ``w = exp(s - m[dst])`` (0 on padding slots), then K1 with ``heads``
    and the denominator in one pass: ``u = sum_dst w feat[src]`` and
    ``den = sum_dst w``; ``out = u / max(den, tiny)``.

    Backward, for a cotangent ``g`` of ``out``, entirely in transpose edge
    order: ``gu = g / den`` and the node-wise ``c = <g, out> / den``; the
    weights recomputed per transpose edge from node tables (``er``, ``m``
    and ``c`` in one gather at the destinations, ``el`` at the sources);
    K2 with ``heads`` on the transpose CSR gives ``d feat`` and
    ``dw = <feat[src], gu[dst]>`` per head in one pass; ``ds0 = w (dw -
    c[dst]) leaky'(s0)``; ``d el`` by ``_segment`` on the transpose CSR and
    ``d er`` by ``_segment`` on the forward CSR after the one crossing of
    edge orders (``perm_f``). ``d m = 0``: the softmax is invariant to the
    shift.

    Where it departs from JAX: the forward does not save ``w``. The JAX
    residual carries it, but its rowmask backward never reads it, so the
    (capacity, H) buffer would only hold memory. ``stream_dtype`` is the
    caller's: bf16 on graphs of at least ``spmm_cuda._BF16_STREAM_MIN_EDGES``
    edge slots, as JAX's ``sdt``.
    """

    @staticmethod
    def forward(ctx, el2, er2, fs, csr, csr_t, slope, stream_dtype):
        n, h, f = fs.shape
        rows, cols = csr.rows_clamped, csr.cols_clamped
        s = _leaky(el2.index_select(0, cols) + er2.index_select(0, rows), slope)
        m = _segment(csr, s, "max")
        w = torch.exp(s - m.index_select(0, rows))
        w = torch.where(csr.edge_mask[:, None], w, torch.zeros((), device=w.device))
        u, den = spmm_rowmask(csr, w, fs.reshape(n, h * f), heads=h, with_denom=True, stream_dtype=stream_dtype)
        denom = den.clamp(min=_TINY)
        out = u.reshape(n, h, f) / denom[:, :, None]
        ctx.graph = (csr, csr_t, slope, stream_dtype)
        ctx.save_for_backward(el2, er2, fs, m, denom, out)
        return out

    @staticmethod
    def backward(ctx, g):
        el2, er2, fs, m, denom, out = ctx.saved_tensors
        csr, csr_t, slope, stream_dtype = ctx.graph
        n, h, f = fs.shape
        g = g.float()
        gu = g / denom[:, :, None]
        c = (g * out).sum(-1) / denom
        side_t = torch.cat([er2, m, c], dim=1).index_select(0, csr_t.cols_clamped)  # one (E, 3H) gather
        er_t, m_t, c_t = side_t[:, :h], side_t[:, h:2 * h], side_t[:, 2 * h:]
        s0_t = el2.index_select(0, csr_t.rows_clamped) + er_t
        w_t = torch.exp(_leaky(s0_t, slope) - m_t)
        w_t = torch.where(csr_t.edge_mask[:, None], w_t, torch.zeros((), device=w_t.device))
        dfs, dw_t = spmm_rowmask_bwd(
            csr_t, w_t, gu.reshape(n, h * f), fs.reshape(n, h * f), stream_dtype=stream_dtype, heads=h
        )
        ds0_t = w_t * (dw_t.reshape(-1, h) - c_t) * torch.where(s0_t >= 0, 1.0, slope)
        dl = _segment(csr_t, ds0_t, "sum")
        der = _segment(csr, ds0_t.index_select(0, positions_in(csr_t, csr.eids)), "sum")
        return dl.to(el2.dtype), der.to(er2.dtype), dfs.reshape(n, h, f).to(fs.dtype), None, None, None, None


def sparse_gat_attention(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    feat_src: torch.Tensor,
    negative_slope: float = 0.2,
    blocked: Optional[BlockedCSR] = None,
    blocked_t: Optional[BlockedCSR] = None,
    csr_t: Optional[CSR] = None,
    attn_drop_rate: float = 0.0,
    attn_drop_seed=0,
) -> torch.Tensor:
    """Large-graph GAT attention: (N, H, 1), (N, H, 1), (N, H, F) -> (N, H, F).

    Routed by the tiling alone, with features streamed as bf16 on graphs of
    at least ``spmm_cuda._BF16_STREAM_MIN_EDGES`` edge slots, as in the JAX
    package: the flash route (K4, K8; K9 in backward) when
    ``flash_supported(H, F)``; else ``RowmaskGat`` when the row-wise kernel
    takes the tiling (``rowmask_eligible``: one head, or ``128 % F == 0``
    and ``(H * F) % 128 == 0``); else the composed route (``ComposedGat``,
    f32) over the blocked layouts ``blocked`` and ``blocked_t`` of ``csr``
    and of its transpose ``csr_t`` (each built once per CSR when not given).

    ``attn_drop_rate`` > 0 (JAX's ``:115-188``) needs the flash route: the
    normalised coefficients are dropped inside K8 and K9 by the hash of
    (src, dst, head, ``attn_drop_seed``) (``flash_gat.edge_keep_mask``; the
    seed a Python int or a one-element integer tensor on the data's
    device). Other tilings raise ``ValueError``, as in JAX; ``GATConv``
    takes its edge-domain route there.
    """
    from stgraph_tpu_torch.ops import spmm_cuda

    n, h, f = feat_src.shape
    sdt = spmm_cuda._stream_dtype(csr, torch.float32)
    if flash_supported(h, f):
        out = flash_gat_attention(
            csr, el[..., 0], er[..., 0], feat_src.reshape(n, h * f), h, negative_slope, sdt,
            attn_drop_rate, attn_drop_seed,
        )
        return out.reshape(n, h, f).to(feat_src.dtype)
    if attn_drop_rate > 0.0:
        raise ValueError("attention dropout needs the flash path; gate on flash_path_available() before calling")
    if csr_t is None:
        csr_t = csr.transpose()
    scores = (el[..., 0].float(), er[..., 0].float(), feat_src.float(), csr, csr_t)
    if rowmask_eligible(h, f):
        out = RowmaskGat.apply(*scores, negative_slope, sdt)
    else:
        blocked, blocked_t = _ensure_blocked(csr, blocked, blocked_t, csr_t)
        out = ComposedGat.apply(*scores, blocked, blocked_t, negative_slope)
    return out.to(feat_src.dtype)


def composed_gat_attention_dropout(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    feat_src: torch.Tensor,
    negative_slope: float,
    attn_drop_rate: float,
    generator: Optional[torch.Generator] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The edge-domain route with attention dropout (the JAX ``GATConv``'s
    route off its flash tilings, ``gat_conv.py:146-173``): explicit per-edge
    coefficients, so the keep mask applies to each; plain torch on any
    device, as JAX's is plain XLA, differentiated by autograd.

    The mask is ``torch.rand`` from ``generator`` (JAX's
    ``jax.random.bernoulli``) unless ``keep`` gives it: a precomputed
    (capacity, H) plane of keep factors in CSR order, 0 or 1/(1-p), such as
    ``flash_gat.edge_keep_mask(csr.cols, csr.rows, seed, H, p)``, the flash
    kernels' own mask."""
    n = csr.num_nodes
    s = M.gather_src(csr, el[..., 0]) + M.gather_dst(csr, er[..., 0])
    s = torch.where(s >= 0, s, negative_slope * s)
    alpha = seg.segment_softmax(s, csr.rows, n, edge_mask=csr.edge_mask)
    if keep is not None:
        if tuple(keep.shape) != tuple(alpha.shape):
            raise ValueError(f"keep must be (capacity, H) = {tuple(alpha.shape)}, got {tuple(keep.shape)}")
        alpha = alpha * keep
    else:
        keep = torch.rand(alpha.shape, generator=generator, device=alpha.device) < 1.0 - attn_drop_rate
        alpha = torch.where(keep, alpha / (1.0 - attn_drop_rate), torch.zeros((), device=alpha.device))
    msg = M.gather_src(csr, feat_src) * alpha[:, :, None]
    return seg.segment_sum(msg, csr.rows, n, edge_mask=csr.edge_mask)
