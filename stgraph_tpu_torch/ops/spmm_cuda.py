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
Multi-head weighted sums whose tiling the row-wise kernel's multi-head
mode would not take go to the blocked kernel K10 (``ops.spmm_blocked``).
"""

from __future__ import annotations

from typing import Optional

import torch

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import message as _msg
from stgraph_tpu_torch.ops.spmm_blocked import rowmask_eligible, spmm_multihead
from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd

__all__ = ["spmm"]

# f32 inputs on graphs at least this large stream bf16 through K1 and K2
# (f32 sums), as in the JAX package: it halves the dominant gathered stream.
_BF16_STREAM_MIN_EDGES = 200_000


def _stream_dtype(csr: CSR, dt: torch.dtype) -> Optional[torch.dtype]:
    if dt == torch.float32 and csr.capacity >= _BF16_STREAM_MIN_EDGES:
        return torch.bfloat16
    return None


class _RowmaskSpmm(torch.autograd.Function):
    """K1 forward; K1 on the transpose (unweighted) or K2 (weighted) backward.

    The cotangent streams bf16 exactly when the forward's features did.
    """

    @staticmethod
    def forward(ctx, h, w, csr, stream_dtype):
        out, _ = spmm_rowmask(csr, w, h, stream_dtype=stream_dtype)
        ctx.csr, ctx.stream_dtype = csr, stream_dtype
        ctx.save_for_backward(h, w)
        return out

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        csr = ctx.csr
        csr_t = csr.transpose()
        g = g.contiguous()
        if w is None:  # constant ones: the plain transpose pass, no SDDMM
            dh, _ = spmm_rowmask(csr_t, None, g, stream_dtype=ctx.stream_dtype)
            return dh.to(h.dtype), None, None, None
        perm_t, perm_f, emask = csr.edge_perms()
        w_t = w.index_select(0, perm_t)
        dh, dw_t = spmm_rowmask_bwd(csr_t, w_t, g, h, stream_dtype=ctx.stream_dtype)
        dw = None
        if ctx.needs_input_grad[1]:
            dw = (dw_t.index_select(0, perm_f) * emask).to(w.dtype)
        return dh.to(h.dtype), dw, None, None


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
    weights): one head through K1; the tilings that the JAX package's
    ``_rowmask_eligible`` refuses through the blocked kernel K10
    (``ops.spmm_blocked``); the others wait for K1's and K2's multi-head
    modes and raise on CUDA (the torch path on the CPU).
    """
    if reduce == "sum" and node_feat.dim() == 3 and edge_weight is not None:
        w = edge_weight.reshape(edge_weight.shape[0], -1)
        n, h, f = node_feat.shape
        if w.shape == (csr.capacity, h):
            if h == 1:
                return spmm(csr, node_feat.reshape(n, f), w, reduce).reshape(n, 1, f)
            if not rowmask_eligible(h, f):
                return spmm_multihead(csr, node_feat, w).to(node_feat.dtype)
            if node_feat.device.type != "cpu":
                raise NotImplementedError(
                    f"a multi-head SpMM at heads={h}, F={f} needs K1's and K2's multi-head modes, "
                    "which are not ported yet (ROADMAP.md)"
                )
        return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    if reduce != "sum" or node_feat.dim() != 2:
        return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    w = None
    if edge_weight is not None:
        w = edge_weight.reshape(-1)
        if w.shape[0] != csr.capacity:
            return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    out = _RowmaskSpmm.apply(node_feat, w, csr, _stream_dtype(csr, node_feat.dtype))
    return out.to(node_feat.dtype)
