"""GAT's segment-softmax attention: the dense path for small graphs, and the
sparse path (flash-GAT's kernels, or the composed torch ops) for large ones.

Counterpart of ``stgraph_tpu/ops/attention.py``:

  * ``dense_gat_attention`` (``:56-110``): per head, the (N, N) scores
    ``leaky(el[s] + er[d])`` masked by edge counts, softmax-normalised per
    destination row and applied as one matmul. Heads run one at a time to
    bound the N^2 temporary. Duplicate edges count with their multiplicity;
    rows without edges come out as exactly 0.
  * ``sparse_gat_attention`` (``:113-359``): the flash route
    (``ops.flash_gat``: K4 and K8 forward, K9 backward) whenever
    ``flash_supported``; otherwise the composed route, plain torch segment
    ops with the stability maximum detached (the JAX VJP's d m = 0).

The composed route on the TPU runs the narrow-sum and wide-max kernels and
K1's and K2's multi-head modes (K3, K5), which are not ported yet, so on a
CUDA tensor it raises; on the CPU it runs the torch ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import message as M
from stgraph_tpu_torch.ops.flash_gat import flash_gat_attention, flash_supported

__all__ = [
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
            f"{what} on {t.device.type} needs the composed GAT route's kernels (the "
            "narrow-sum and wide-max kernels K3 and K5, and K1/K2's multi-head modes), "
            "which are not ported yet (ROADMAP.md, item 7); use heads <= 16 and "
            "heads * out_feats <= 256 for the flash route"
        )


def sparse_gat_attention(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    feat_src: torch.Tensor,
    negative_slope: float = 0.2,
) -> torch.Tensor:
    """Large-graph GAT attention: (N, H, 1), (N, H, 1), (N, H, F) -> (N, H, F).

    Flash route (K4, K8; K9 in backward) when ``flash_supported(H, F)``,
    with features streamed as bf16 on graphs of at least
    ``spmm_cuda._BF16_STREAM_MIN_EDGES`` edge slots, as in the JAX package.
    Otherwise the composed route: the edge-domain softmax in torch segment
    ops, differentiated by autograd with the maximum detached.
    """
    from stgraph_tpu_torch.ops import spmm_cuda

    n, h, f = feat_src.shape
    if flash_supported(h, f):
        sdt = spmm_cuda._stream_dtype(csr, torch.float32)
        out = flash_gat_attention(
            csr, el[..., 0], er[..., 0], feat_src.reshape(n, h * f), h, negative_slope, sdt
        )
        return out.reshape(n, h, f).to(feat_src.dtype)
    _require_cpu(feat_src, f"GAT attention with heads={h}, F={f}")
    s = M.gather_src(csr, el[..., 0]) + M.gather_dst(csr, er[..., 0])
    s = torch.where(s >= 0, s, negative_slope * s)
    m = M.aggregate(csr, s, reduce="max").detach()
    w = torch.exp(s - M.gather_dst(csr, m)) * csr.edge_mask[:, None]
    denom = M.aggregate(csr, w, reduce="sum").clamp(min=_TINY)
    u = M.spmm(csr, feat_src, edge_weight=w, impl="torch")
    return (u / denom[:, :, None]).to(feat_src.dtype)


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
    from stgraph_tpu_torch.ops import segment as seg

    _require_cpu(feat_src, "GAT attention dropout off the flash route")
    n = csr.num_nodes
    s = M.gather_src(csr, el[..., 0]) + M.gather_dst(csr, er[..., 0])
    s = torch.where(s >= 0, s, negative_slope * s)
    alpha = seg.segment_softmax(s, csr.rows, n, edge_mask=csr.edge_mask)
    keep = torch.rand(alpha.shape, generator=generator, device=alpha.device) < 1.0 - attn_drop_rate
    alpha = torch.where(keep, alpha / (1.0 - attn_drop_rate), torch.zeros((), device=alpha.device))
    msg = M.gather_src(csr, feat_src) * alpha[:, :, None]
    return seg.segment_sum(msg, csr.rows, n, edge_mask=csr.edge_mask)
