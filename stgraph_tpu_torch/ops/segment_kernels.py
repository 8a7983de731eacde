"""K3 and K4: the narrow segment sum and max, each with its wrapper, its
plain PyTorch version and its autograd function.

Replaces ``stgraph_tpu/ops/segment_pallas.py``'s ``segment_max_narrow``
(``:379-463``) and its Pallas kernel ``_narrow_max_kernel`` (``:235``):

    out[d, k] = max_{e in row d} vals[e, k]        (f32, K <= 16)

Empty rows give 0 (so does a row whose maximum is -inf), and padding slots
never count. An optional per-edge ``index`` reads the values from a node
table, ``vals[index[e], k]``: flash-GAT passes ``el`` (N, H) and ``cols``
and never builds the (E, H) plane (3.96 GB at ogbn-products size).

The CUDA kernel lives in ``csrc/segment_max_narrow.cu``. On this card it
is bound by memory: one compare per gathered value; the compulsory bytes
(``indptr``, ``cols``, the table and the output once) take about 0.2 ms at
ogbn-products size with H = 8. It shares K1's work items.

``SegmentMaxNarrow`` is the differentiable form. Its backward is the plain
argmax mask of the JAX custom VJP (``:449-463``): every edge whose value
equals its row's maximum receives the row's cotangent, so ties
double-count. It is plain torch, as the JAX backward is plain ``jnp``.

K3 (``segment_sum_narrow``, ``csrc/segment_sum_narrow.cu``) replaces
``segment_pallas.segment_sum_narrow`` (``:316-377``) and its Pallas kernel
``_narrow_sum_kernel`` (``:155``):

    out[d, k] = sum_{e in row d} vals[e, k]        (f32, K <= 16)

over an (E, K) plane in CSR order; padding slots never count, and empty
rows give 0. It takes K4's design with a sum in place of the max, and its
bound is of the same kind: memory, about 0.6 ms at ogbn-products size with
K = 4. ``SegmentSumNarrow``'s backward is the destination gather
``g[rows] * emask`` of the JAX custom VJP, in plain torch.

The wrappers take their plain versions only because the tensor they were
given lies on the CPU. For a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import kernel_lib
from stgraph_tpu_torch.ops.spmm_kernels import ROW_CHUNK, _work_items

__all__ = [
    "MAX_NARROW_K",
    "SegmentMaxNarrow",
    "SegmentSumNarrow",
    "segment_max_narrow",
    "segment_max_narrow_plain",
    "segment_sum_narrow",
    "segment_sum_narrow_plain",
]

# Largest trailing width the narrow kernel takes (the JAX package's bound).
MAX_NARROW_K = 16

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stg_segment_max_narrow": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _VP, _I, _I, _VP],
}
_K3_SIGNATURES = {
    "stg_segment_sum_narrow": [_VP, _VP, _VP, _VP, _I, _VP, _I, _I, _VP],
}


def _check(csr: CSR, vals: torch.Tensor, index: Optional[torch.Tensor]) -> int:
    if vals.dim() != 2:
        raise ValueError(f"vals must be (rows, K), got {tuple(vals.shape)}")
    k = vals.shape[1]
    if not 1 <= k <= MAX_NARROW_K:
        raise ValueError(f"trailing width {k} is not in 1..MAX_NARROW_K={MAX_NARROW_K}")
    if index is None and vals.shape[0] != csr.capacity:
        raise ValueError(f"per-edge vals must have {csr.capacity} rows, got {vals.shape[0]}")
    if index is not None and index.numel() != csr.capacity:
        raise ValueError(f"index must hold one id per edge slot ({csr.capacity})")
    return k


def segment_max_narrow_plain(
    csr: CSR,
    vals: torch.Tensor,
    index: Optional[torch.Tensor] = None,
    edge_block: Optional[int] = None,
) -> torch.Tensor:
    """K4's plain version: gather (with ``index``), then a masked
    ``scatter_reduce`` ``amax`` over the real edges; -inf becomes 0.

    ``edge_block`` bounds the (edges, K) temporaries: the edges are taken in
    blocks of that many, each folded into the running maximum. A maximum is
    exact, so the result does not depend on it.
    """
    k = _check(csr, vals, index)
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    out = torch.full((n, k), float("-inf"), dtype=torch.float32, device=vals.device)
    block = max(e, 1) if edge_block is None else edge_block
    for e0 in range(0, e, block):
        e1 = min(e0 + block, e)
        v = vals[index[e0:e1].long()] if index is not None else vals[e0:e1]
        rows = csr.rows[e0:e1].long()[:, None].expand(-1, k)
        out.scatter_reduce_(0, rows, v.to(torch.float32), "amax", include_self=True)
    return out.masked_fill_(torch.isneginf(out), 0.0)


def segment_max_narrow(
    csr: CSR, vals: torch.Tensor, index: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K4: ``out[d, k] = max over row d of vals[e, k]`` (or of
    ``vals[index[e], k]``), (N, K) f32; empty rows give 0.

    ``vals`` is (capacity, K) in CSR order, or with ``index`` (capacity,)
    int32 a node table (rows, K). Not differentiable: ``SegmentMaxNarrow``
    is.
    """
    k = _check(csr, vals, index)
    if vals.device.type == "cpu":
        return segment_max_narrow_plain(csr, vals, index)

    lib = kernel_lib.load("segment_max_narrow", _SIGNATURES)
    dev = vals.device
    if csr.device != dev or (index is not None and index.device != dev):
        raise ValueError(f"K4 needs the CSR, vals and index on one CUDA device, got {csr.device} and {dev}")
    if index is not None and index.dtype != torch.int32:
        raise ValueError(f"K4's index must be int32, got {index.dtype}")
    if vals.shape[0] * k >= 2**31 or csr.capacity + ROW_CHUNK >= 2**31:
        raise ValueError("K4 indexes rows and edges with int32; the graph is too large")
    table = vals.to(torch.float32).contiguous()
    n = csr.num_nodes
    out = torch.empty(n, k, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    item_row, item_beg, split_rows = _work_items(csr)
    if split_rows.numel():
        out.index_fill_(0, split_rows, float("-inf"))
    rc = lib.stg_segment_max_narrow(
        csr.indptr.data_ptr(),
        None if index is None else index.contiguous().data_ptr(),
        table.data_ptr(),
        item_row.data_ptr(),
        item_beg.data_ptr(),
        item_row.numel(),
        split_rows.data_ptr(),
        split_rows.numel(),
        out.data_ptr(),
        k,
        ROW_CHUNK,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K4 (segment_max_narrow) launch failed with cudaError {rc}")
    segment_max_narrow.launches += 1
    return out


segment_max_narrow.launches = 0  # kernel launches since the count was last reset


class SegmentMaxNarrow(torch.autograd.Function):
    """``segment_max_narrow`` with the argmax-mask gradient: the row's
    cotangent goes to every real edge whose value equals the row's maximum
    (ties double-count). With ``index`` the per-edge gradients are summed
    into the node table's rows."""

    @staticmethod
    def forward(ctx, vals, csr, index=None):
        out = segment_max_narrow(csr, vals, index)
        ctx.csr = csr
        ctx.save_for_backward(vals, out, index)
        return out

    @staticmethod
    def backward(ctx, g):
        vals, out, index = ctx.saved_tensors
        csr = ctx.csr
        rows = csr.rows_clamped.long()
        v = vals if index is None else vals[index.clamp(max=vals.shape[0] - 1).long()]
        is_max = (v == out[rows]) & csr.edge_mask[:, None]
        dv = torch.where(is_max, g[rows], torch.zeros((), dtype=g.dtype, device=g.device))
        if index is not None:
            valid = csr.edge_mask
            dv = torch.zeros_like(vals).index_add(0, index[valid].long(), dv[valid])
        return dv.to(vals.dtype), None, None


def segment_sum_narrow_plain(csr: CSR, vals: torch.Tensor, edge_block: Optional[int] = None) -> torch.Tensor:
    """K3's plain version: a masked ``index_add`` over the real edges, summed
    in f64 and rounded once to f32, so it is the reference that the kernel's
    f32 sums (in any order) approximate. ``edge_block`` bounds the (edges,
    K) f64 temporaries; the result does not depend on it."""
    k = _check(csr, vals, None)
    e = int(csr.host_arrays()[0][-1])
    out = torch.zeros(csr.num_nodes, k, dtype=torch.float64, device=vals.device)
    block = max(e, 1) if edge_block is None else edge_block
    for e0 in range(0, e, block):
        e1 = min(e0 + block, e)
        out.index_add_(0, csr.rows[e0:e1].long(), vals[e0:e1].double())
    return out.float()


def segment_sum_narrow(csr: CSR, vals: torch.Tensor) -> torch.Tensor:
    """K3: ``out[d, k] = sum over row d of vals[e, k]``, (N, K) f32; empty
    rows give 0. ``vals`` is (capacity, K) in CSR order, K <= 16. Not
    differentiable: ``SegmentSumNarrow`` is."""
    k = _check(csr, vals, None)
    if vals.device.type == "cpu":
        return segment_sum_narrow_plain(csr, vals)

    lib = kernel_lib.load("segment_sum_narrow", _K3_SIGNATURES)
    dev = vals.device
    if csr.device != dev:
        raise ValueError(f"K3 needs the CSR and vals on one CUDA device, got {csr.device} and {dev}")
    if vals.shape[0] * k >= 2**31 or csr.capacity + ROW_CHUNK >= 2**31:
        raise ValueError("K3 indexes edges with int32; the graph is too large")
    plane = vals.to(torch.float32).contiguous()
    n = csr.num_nodes
    out = torch.empty(n, k, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    item_row, item_beg, split_rows = _work_items(csr)
    if split_rows.numel():
        out.index_fill_(0, split_rows, 0.0)
    rc = lib.stg_segment_sum_narrow(
        csr.indptr.data_ptr(),
        plane.data_ptr(),
        item_row.data_ptr(),
        item_beg.data_ptr(),
        item_row.numel(),
        out.data_ptr(),
        k,
        ROW_CHUNK,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K3 (segment_sum_narrow) launch failed with cudaError {rc}")
    segment_sum_narrow.launches += 1
    return out


segment_sum_narrow.launches = 0  # kernel launches since the count was last reset


class SegmentSumNarrow(torch.autograd.Function):
    """``segment_sum_narrow`` with the JAX custom VJP's gradient: each real
    edge takes its destination row's cotangent, padding slots 0."""

    @staticmethod
    def forward(ctx, vals, csr):
        ctx.csr = csr
        return segment_sum_narrow(csr, vals)

    @staticmethod
    def backward(ctx, g):
        csr = ctx.csr
        dv = g[csr.rows_clamped.long()] * csr.edge_mask[:, None].to(g.dtype)
        return dv, None
