"""Kernel SpMM entry point: the counterpart of ``stgraph_tpu/ops/spmm_pallas.py``
(``spmm`` ``:601-666``, ``_stream_dtype`` ``:592-598`` and
``_make_rowmask_spmm`` ``:420-491``). It is named for its route, as the JAX
module is; ``ops.spmm`` is the function that ``ops/__init__`` exports.

``_RowmaskSpmm`` is the custom VJP. Its forward launches K1
(``ops.spmm_kernels.spmm_rowmask``). Its backward runs on the transpose
CSR: K1 again for an unweighted SpMM, and K2 (``spmm_rowmask_bwd``, ``dh``
and the per-edge ``dw`` in one pass) for a weighted one, whose ``dw`` is
then permuted back to forward edge order. CPU tensors take the same
function, with the plain versions of K1 and K2 inside, so the CPU tests
exercise the real backward. The JAX package's ``src_ids`` variant exists
only for the TPU's compile-request limit and has no counterpart.
Multi-head weighted sums take K1's and K2's heads modes through the same
function where the row-wise kernel takes the tiling (``rowmask_eligible``),
and the blocked kernel K10 (``ops.spmm_blocked``) otherwise.

``segment_sum_edges`` is the counterpart of ``spmm_pallas.segment_sum_edges``
(``:691-737``): CSR-ordered edge values summed into their destination rows,
with a gather for its backward. JAX permutes the values into blocked order
for its selection-matmul kernel (K10); CSR order is already sorted by
destination, so the port sums the rows in place: K3 up to ``MAX_NARROW_K``
trailing columns, K1's no-gather mode past it, at every graph size (JAX
always takes its kernel here).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import message as _msg
from stgraph_tpu_torch.ops import segment_kernels as _sk
from stgraph_tpu_torch.ops.spmm_blocked import rowmask_eligible, spmm_multihead
from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd, spmm_rowmask_traced

__all__ = ["segment_sum_edges", "spmm", "spmm_traced"]

# f32 inputs on graphs at least this large stream bf16 through K1 and K2
# (f32 sums), as in the JAX package: it halves the dominant gathered stream.
_BF16_STREAM_MIN_EDGES = 200_000


def _stream_dtype(csr: CSR, dt: torch.dtype) -> Optional[torch.dtype]:
    if dt == torch.float32 and csr.capacity >= _BF16_STREAM_MIN_EDGES:
        return torch.bfloat16
    return None


class _RowmaskSpmm(torch.autograd.Function):
    """K1 forward; K1 on the transpose (unweighted) or K2 (weighted) backward.

    ``h`` is (num_cols, heads * F) and ``w`` (capacity,) for one head or
    (capacity, heads); the CSR may be rectangular, and its transpose then
    is too. The cotangent streams bf16 exactly when the forward's features
    did. ``traced`` runs the forward on K1's shard mode
    (``spmm_rowmask_traced``: the stream is ``h``'s dtype, ``stream_dtype``
    is ignored): ``spmm_traced`` is that entry.
    """

    @staticmethod
    def forward(ctx, h, w, csr, stream_dtype, heads, traced=False):
        if traced:
            out, _ = spmm_rowmask_traced(csr, w, h, heads=heads)
            stream_dtype = torch.bfloat16 if h.dtype == torch.bfloat16 else torch.float32
        else:
            out, _ = spmm_rowmask(csr, w, h, heads=heads, stream_dtype=stream_dtype)
        ctx.csr, ctx.stream_dtype, ctx.heads = csr, stream_dtype, heads
        ctx.save_for_backward(h, w)
        return out

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        csr, heads = ctx.csr, ctx.heads
        csr_t = csr.transpose()
        g = g.contiguous()
        if w is None:  # constant ones: the plain transpose pass, no SDDMM
            dh, _ = spmm_rowmask(csr_t, None, g, stream_dtype=ctx.stream_dtype)
            return dh.to(h.dtype), None, None, None, None, None
        perm_t, perm_f, emask = csr.edge_perms()
        w_t = w.index_select(0, perm_t)
        dh, dw_t = spmm_rowmask_bwd(csr_t, w_t, g, h, stream_dtype=ctx.stream_dtype, heads=heads)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = (dw_t.index_select(0, perm_f) * emask.reshape((-1,) + (1,) * (dw_t.dim() - 1))).to(w.dtype)
        return dh.to(h.dtype), dw, None, None, None, None


def spmm(
    csr: CSR,
    node_feat: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    reduce: str = "sum",
) -> torch.Tensor:
    """Kernel SpMM matching ``ops.message.spmm``'s contract.

    Sums over (N, F) features go through K1 (and K1/K2 backward);
    max/min/mean and 3-D features take the torch path as in the JAX
    package. Multi-head weighted sums ((N, H, F) features, (capacity, H)
    weights): the tilings of the JAX package's ``_rowmask_eligible``
    (``spmm_pallas.py:579-584``; one head among them) through K1's heads
    mode (K2's in backward), the others through the blocked kernel K10
    (``ops.spmm_blocked``), as the JAX package's ``spmm`` routes them.
    """
    if reduce == "sum" and node_feat.dim() == 3 and edge_weight is not None:
        w = edge_weight.reshape(edge_weight.shape[0], -1)
        n, h, f = node_feat.shape
        if w.shape == (csr.capacity, h):
            if not rowmask_eligible(h, f):
                return spmm_multihead(csr, node_feat, w).to(node_feat.dtype)
            flat = node_feat.reshape(n, h * f)
            out = _RowmaskSpmm.apply(flat, w if h > 1 else w.reshape(-1), csr, _stream_dtype(csr, flat.dtype), h)
            return out.reshape(n, h, f).to(node_feat.dtype)
        return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    if reduce != "sum" or node_feat.dim() != 2:
        return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    w = None
    if edge_weight is not None:
        w = edge_weight.reshape(-1)
        if w.shape[0] != csr.capacity:
            return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    out = _RowmaskSpmm.apply(node_feat, w, csr, _stream_dtype(csr, node_feat.dtype), 1)
    return out.to(node_feat.dtype)


def spmm_traced(csr: CSR, h: torch.Tensor, w: Optional[torch.Tensor] = None, heads: int = 1) -> torch.Tensor:
    """``out[d, c] = sum_e w[e, c // F] * h[col_e, c]`` on K1's shard mode
    (``spmm_rowmask_traced``), differentiable in ``h`` and ``w``: the
    distribution layer's shard reduction.

    ``csr`` may be rectangular: ``h`` has ``csr.num_cols`` rows and the
    result ``csr.num_nodes``. ``w`` is None (unweighted), (capacity,) for one
    head or (capacity, heads). The stream is ``h``'s dtype (bf16 or f32), as
    JAX's traced kernel streams the gathered dtype; the backward runs K1 on
    the transpose (unweighted) or K2 (weighted) on the same stream.
    """
    return _RowmaskSpmm.apply(h, w, csr, None, heads, True).to(h.dtype)


def segment_sum_edges(csr: CSR, edge_vals: torch.Tensor, blocked=None) -> torch.Tensor:
    """Sum CSR-ordered edge values into their destination rows.

    ``edge_vals`` is (capacity, ...) in CSR edge order; the result is
    (num_nodes, ...) f32, whatever the values' dtype (bf16 values are summed
    in f32), as JAX's kernel returns it. Padding slots add nothing. The
    backward is a gather: each real edge takes its destination row's
    cotangent, padding slots 0. On a CUDA tensor K3 or K1's no-gather mode
    sums (one kernel launch a call; bf16 values are first widened to an f32
    plane by one PyTorch cast, as both kernels read f32); CPU tensors take
    their plain versions.
    ``blocked`` is accepted for the JAX signature and ignored: the port
    needs no blocked layout here.
    """
    if edge_vals.shape[0] != csr.capacity:
        raise ValueError(f"edge_vals must have {csr.capacity} rows (the CSR's capacity), got {edge_vals.shape[0]}")
    trailing = tuple(edge_vals.shape[1:])
    k = int(np.prod(trailing)) if trailing else 1
    v = edge_vals.reshape(csr.capacity, k)
    if k <= _sk.MAX_NARROW_K:
        out = _sk.SegmentSumNarrow.apply(v, csr)
    else:  # bf16 stream only for bf16 values (JAX's K10 streams f32 for f32 values at every size)
        out = _sk.SegmentSumWide.apply(v, csr, v.dtype == torch.bfloat16)
    return out.reshape((csr.num_nodes,) + trailing)
