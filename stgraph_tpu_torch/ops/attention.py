"""GAT's segment-softmax attention: the dense path for small graphs, and the
sparse path (flash-GAT's kernels, or the composed route) for large ones.

Counterpart of ``stgraph_tpu/ops/attention.py``:

  * ``dense_gat_attention`` (``:56-110``): per head, the (N, N) scores
    ``leaky(el[s] + er[d])`` masked by edge counts, softmax-normalised per
    destination row and applied as one matmul. Heads run one at a time to
    bound the N^2 temporary. Duplicate edges count with their multiplicity;
    rows without edges come out as exactly 0.
  * ``sparse_gat_attention`` (``:113-359``): the flash route
    (``ops.flash_gat``: K4 and K8 forward, K9 backward) whenever
    ``flash_supported``; otherwise the composed route, ``ComposedGat``, the
    JAX custom VJP's non-rowmask branch (``:225-280`` forward, ``:282-352``
    backward): K4 for the stability maximum, K3 for the softmax
    denominator, the blocked kernel K10 for the weighted aggregation; in
    backward K10 on the transpose layout for ``d feat``, the per-head SDDMM
    in plain torch, and K3 for ``d er`` and ``d el``.

On CUDA the composed route takes the tilings that the JAX package sends to
its blocked kernel (H > 1 with ``128 % F != 0`` or ``(H * F) % 128 != 0``)
with H <= 16. It raises for the others, naming what they wait for: K5 (the
wide segment max) for H > 16, and K1's and K2's multi-head modes for the
rowmask tilings off the flash route. On the CPU it runs the kernels' plain
versions (and the torch segment ops past 16 heads).
"""

from __future__ import annotations

from typing import Optional

import torch

from stgraph_tpu_torch.graph.blocked import BlockedCSR
from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import message as M
from stgraph_tpu_torch.ops import segment as seg
from stgraph_tpu_torch.ops.flash_gat import flash_gat_attention, flash_supported
from stgraph_tpu_torch.ops.segment_kernels import MAX_NARROW_K, segment_max_narrow, segment_sum_narrow
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


def _require_cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise NotImplementedError(
            f"{what} on {t.device.type} runs on the CPU only: on CUDA the port gives attention "
            "dropout to K8's and K9's dropout mode (the stateless edge_keep_mask hash), which is "
            "not ported yet (ROADMAP.md), and the composed route's kernels (K3, K4, K10) take no "
            "dropout mask; train with attn_drop=0"
        )


def _segment(csr: CSR, vals: torch.Tensor, reduce: str) -> torch.Tensor:
    """K4 (``max``) or K3 (``sum``) of a (capacity, H) plane; past
    ``MAX_NARROW_K`` heads (which CUDA callers never reach) the torch segment
    ops, with the same conventions."""
    if vals.shape[1] <= MAX_NARROW_K:
        return (segment_max_narrow if reduce == "max" else segment_sum_narrow)(csr, vals)
    fn = seg.segment_max if reduce == "max" else seg.segment_sum
    return fn(vals, csr.rows, csr.num_nodes, edge_mask=csr.edge_mask)


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


def sparse_gat_attention(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    feat_src: torch.Tensor,
    negative_slope: float = 0.2,
    blocked: Optional[BlockedCSR] = None,
    blocked_t: Optional[BlockedCSR] = None,
    csr_t: Optional[CSR] = None,
) -> torch.Tensor:
    """Large-graph GAT attention: (N, H, 1), (N, H, 1), (N, H, F) -> (N, H, F).

    Flash route (K4, K8; K9 in backward) when ``flash_supported(H, F)``,
    with features streamed as bf16 on graphs of at least
    ``spmm_cuda._BF16_STREAM_MIN_EDGES`` edge slots, as in the JAX package.
    Otherwise the composed route (``ComposedGat``, f32) over the blocked
    layouts ``blocked`` and ``blocked_t`` of ``csr`` and of its transpose
    ``csr_t`` (each built once per CSR when not given).
    """
    from stgraph_tpu_torch.ops import spmm_cuda

    n, h, f = feat_src.shape
    if flash_supported(h, f):
        sdt = spmm_cuda._stream_dtype(csr, torch.float32)
        out = flash_gat_attention(
            csr, el[..., 0], er[..., 0], feat_src.reshape(n, h * f), h, negative_slope, sdt
        )
        return out.reshape(n, h, f).to(feat_src.dtype)
    if feat_src.device.type != "cpu":
        if h > MAX_NARROW_K:
            raise NotImplementedError(
                f"GAT attention with heads={h} > {MAX_NARROW_K} on CUDA needs the wide segment-max "
                "kernel K5, which is not ported yet (ROADMAP.md)"
            )
        if rowmask_eligible(h, f):
            raise NotImplementedError(
                f"GAT attention with heads={h}, F={f} off the flash route needs K1's and K2's "
                "multi-head modes (the JAX package's rowmask tilings), which are not ported yet "
                "(ROADMAP.md); the flash route takes heads <= 16 and heads * F <= 256"
            )
    if csr_t is None:
        csr_t = csr.transpose()
    blocked, blocked_t = _ensure_blocked(csr, blocked, blocked_t, csr_t)
    out = ComposedGat.apply(
        el[..., 0].float(), er[..., 0].float(), feat_src.float(), csr, csr_t, blocked, blocked_t, negative_slope
    )
    return out.to(feat_src.dtype)


def composed_gat_attention_dropout(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    feat_src: torch.Tensor,
    negative_slope: float,
    attn_drop_rate: float,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The edge-domain route with attention dropout (the JAX ``GATConv``'s
    fallback, ``gat_conv.py:146-173``): explicit per-edge coefficients, so
    the keep mask applies to each; differentiated by autograd."""
    _require_cpu(feat_src, "GAT attention dropout off the flash route")
    n = csr.num_nodes
    s = M.gather_src(csr, el[..., 0]) + M.gather_dst(csr, er[..., 0])
    s = torch.where(s >= 0, s, negative_slope * s)
    alpha = seg.segment_softmax(s, csr.rows, n, edge_mask=csr.edge_mask)
    keep = torch.rand(alpha.shape, generator=generator, device=alpha.device) < 1.0 - attn_drop_rate
    alpha = torch.where(keep, alpha / (1.0 - attn_drop_rate), torch.zeros((), device=alpha.device))
    msg = M.gather_src(csr, feat_src) * alpha[:, :, None]
    return seg.segment_sum(msg, csr.rows, n, edge_mask=csr.edge_mask)
