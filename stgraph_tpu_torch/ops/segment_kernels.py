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
ogbn-products size with H = 8. It walks K1's work items at its own length
(``K4_CHUNK`` edges an item), 16 lanes an item, and finishes its
split rows itself with a ticket counter a split row (zeros kept on the CSR
beside the items, left zero by every launch).

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
K = 4. It walks K5's int4 work items (``k5_work_items``, the split rows'
first) at its own length (``K3_CHUNK``), 8 lanes an item, and finishes
split rows in the same launch and in a fixed order: each item of a split
row stores its sums in a scratch slot of its own, and the last item to
take the row's ticket sums them (``_k3_plan`` keeps the items, slots and
tickets on the CSR). One launch a call, and the same sums from run to
run. ``SegmentSumNarrow``'s backward is the destination gather
``g[rows] * emask`` of the JAX custom VJP, in plain torch.

K5 (``segment_max_wide``, ``csrc/segment_max_wide.cu``) replaces
``segment_pallas.segment_max_wide`` (``:620-654``) and its Pallas kernel
``_wide_max_kernel`` (``:466``, through ``_wide_call`` ``:573``): K4's
maximum for any width K, empty rows 0. It walks its own work items
(``k5_work_items``: one int4 an item, at most ``K5_CHUNK`` edges), 16 lanes
an item, and finishes split rows in the same launch through a scratch row
of -inf and a ticket a split row, both kept on the CSR and left as they
were by every launch: one launch a call. K1's no-gather mode
(``segment_sum_wide``, ``csrc/segment_sum_wide.cu``) replaces
``segment_pallas.segment_sum_wide`` (``:661-760``), the row-wise SpMM
kernel run on the (E, K) plane itself: K3's sum for any width, with the
values rounded to bf16 (f32 sums) when the graph has at least
``WIDE_BF16_MIN_SLOTS`` edge slots and the values are f32, as the JAX
package's ``:682-686``. Both are bound by memory (they read the plane once,
in CSR order) and share one lane mapping: lanes as (edge offset, group of
4 columns) pairs, so a narrow row keeps every lane busy. ``SegmentMaxWide``
and ``SegmentSumWide`` carry the JAX custom VJPs (``:648-654`` and
``:741-747``): the argmax mask (ties double-count, padding gets nothing)
and the destination gather.

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
from stgraph_tpu_torch.ops.spmm_kernels import K1_CHUNK, ROW_CHUNK, _work_items, k1_work_items

__all__ = [
    "K3_CHUNK",
    "K4_CHUNK",
    "K5_CHUNK",
    "MAX_NARROW_K",
    "SegmentMaxNarrow",
    "SegmentMaxWide",
    "SegmentSumNarrow",
    "SegmentSumWide",
    "WIDE_BF16_MIN_SLOTS",
    "segment_max_narrow",
    "segment_max_narrow_plain",
    "segment_max_wide",
    "segment_max_wide_plain",
    "segment_sum_narrow",
    "segment_sum_narrow_plain",
    "segment_sum_wide",
    "segment_sum_wide_plain",
    "k5_work_items",
    "wide_stream_is_bf16",
]

# Largest trailing width the narrow kernel takes (the JAX package's bound).
MAX_NARROW_K = 16
# K3's work items (k5_work_items): at most K3_CHUNK edges each.
K3_CHUNK = 256
# K4's work items: at most K4_CHUNK edges each.
K4_CHUNK = 1024
# K5's work items (k5_work_items): at most K5_CHUNK edges each.
K5_CHUNK = 128

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stg_segment_max_narrow": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _VP, _VP, _I, _I, _VP],
}
_K3_SIGNATURES = {
    "stg_segment_sum_narrow": [_VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _I, _I, _VP],
}
_K5_SIGNATURES = {
    "stg_segment_max_wide": [_VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _I, _VP],
}
_WIDE_SUM_SIGNATURES = {
    "stg_segment_sum_wide": [_VP, _VP, _I, _VP, _VP, _I, _VP, _I, _I, _VP],
}

# f32 values on graphs of at least this many edge slots stream bf16 through
# the no-gather sum (f32 sums): the JAX package's literal at
# segment_pallas.py:684, the SpMM's threshold.
WIDE_BF16_MIN_SLOTS = 200_000


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


def _max_plain(csr: CSR, vals: torch.Tensor, index: Optional[torch.Tensor], k: int, edge_block: Optional[int]):
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
    return _max_plain(csr, vals, index, _check(csr, vals, index), edge_block)


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
    if vals.shape[0] * k >= 2**31 or csr.capacity + K4_CHUNK >= 2**31:
        raise ValueError("K4 indexes rows and edges with int32; the graph is too large")
    n = csr.num_nodes
    out = torch.empty(n, k, dtype=torch.float32, device=dev)
    table = vals.to(torch.float32).contiguous()
    if n == 0:
        return out
    chunk = K4_CHUNK
    item_row, item_beg, split_rows = _work_items(csr, chunk)
    tickets = csr.cached(f"k4_tickets_{chunk}",
                         lambda: torch.zeros(split_rows.numel(), dtype=torch.int32, device=dev))
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
        tickets.data_ptr(),
        out.data_ptr(),
        k,
        chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K4 (segment_max_narrow) launch failed with cudaError {rc}")
    segment_max_narrow.launches += 1
    return out


segment_max_narrow.launches = 0  # kernel launches since the count was last reset


def _max_edge_grad(csr: CSR, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The argmax-mask gradient of a segment max over per-edge values ``v``:
    the row's cotangent to every real edge whose value equals the row's
    maximum (ties double-count), 0 elsewhere."""
    rows = csr.rows_clamped.long()
    is_max = (v == out[rows]) & csr.edge_mask[:, None]
    return torch.where(is_max, g[rows], torch.zeros((), dtype=g.dtype, device=g.device))


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
        v = vals if index is None else vals[index.clamp(max=vals.shape[0] - 1).long()]
        dv = _max_edge_grad(csr, v, out, g)
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


def _k3_plan(csr: CSR, chunk: int, k: int):
    """K3's work items on the CSR's device (``k5_work_items`` at ``chunk``
    edges, the split rows' items first: their last sums then run early, not
    at the launch's end), each split row's (first scratch slot, item count,
    first edge, 0) and its ticket (zeros), made once per CSR and kept there,
    and a scratch of k f32 a split row's item, one a width: every launch
    leaves the tickets 0, so K3's launches on one CSR stay ordered on one
    stream."""

    def make():
        indptr = csr.host_arrays()[0]
        items, split_rows, split_items = k5_work_items(indptr, chunk)
        items = items[np.argsort(items[:, 0] >= 0, kind="stable")]  # split rows (~row < 0) first
        first = np.cumsum(split_items, dtype=np.int64) - split_items
        split = np.stack([first, split_items, np.asarray(indptr)[split_rows], np.zeros_like(first)], 1)
        dev = csr.device
        return (torch.from_numpy(items).to(dev), torch.from_numpy(split.astype(np.int32)).to(dev),
                torch.zeros(split_rows.size, dtype=torch.int32, device=dev), int(split_items.sum()))

    items, split, tickets, slots = csr.cached(f"k3_items_{chunk}", make)
    scratch = csr.cached(f"k3_scratch_{chunk}_{k}",
                         lambda: torch.empty(slots, k, dtype=torch.float32, device=csr.device))
    return items, split, tickets, scratch


def segment_sum_narrow(csr: CSR, vals: torch.Tensor) -> torch.Tensor:
    """K3: ``out[d, k] = sum over row d of vals[e, k]``, (N, K) f32; empty
    rows give 0. ``vals`` is (capacity, K) in CSR order, K <= 16. Not
    differentiable: ``SegmentSumNarrow`` is. One launch a call."""
    k = _check(csr, vals, None)
    if vals.device.type == "cpu":
        return segment_sum_narrow_plain(csr, vals)

    lib = kernel_lib.load("segment_sum_narrow", _K3_SIGNATURES)
    dev = vals.device
    if csr.device != dev:
        raise ValueError(f"K3 needs the CSR and vals on one CUDA device, got {csr.device} and {dev}")
    chunk = K3_CHUNK
    if vals.shape[0] * k >= 2**31 or csr.capacity + chunk >= 2**31:
        raise ValueError("K3 indexes edges with int32; the graph is too large")
    n = csr.num_nodes
    # allocated first, so the poisoned-output checks find it in the block freed just before
    out = torch.empty(n, k, dtype=torch.float32, device=dev)
    if n == 0:
        return out
    plane = vals if vals.dtype == torch.float32 and vals.is_contiguous() else vals.to(torch.float32).contiguous()
    items, split, tickets, scratch = _k3_plan(csr, chunk, k)
    rc = lib.stg_segment_sum_narrow(
        plane.data_ptr(),
        items.data_ptr(),
        items.shape[0],
        split.data_ptr(),
        split.shape[0],
        tickets.data_ptr(),
        scratch.data_ptr(),
        out.data_ptr(),
        k,
        chunk,
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


def _check_wide(csr: CSR, vals: torch.Tensor) -> int:
    if vals.dim() != 2 or vals.shape[1] < 1:
        raise ValueError(f"vals must be (capacity, K) with K >= 1, got {tuple(vals.shape)}")
    if vals.shape[0] != csr.capacity:
        raise ValueError(f"per-edge vals must have {csr.capacity} rows, got {vals.shape[0]}")
    if vals.numel() >= 2**31 or csr.capacity + ROW_CHUNK >= 2**31:
        raise ValueError("the wide kernels index edges with int32; the plane is too large")
    return vals.shape[1]


def segment_max_wide_plain(csr: CSR, vals: torch.Tensor, edge_block: Optional[int] = None) -> torch.Tensor:
    """K5's plain version: K4's (a masked ``scatter_reduce`` ``amax``, -inf
    becomes 0) for any width. Exact, so the kernel equals it bit for bit."""
    return _max_plain(csr, vals, None, _check_wide(csr, vals), edge_block)


def k5_work_items(indptr: np.ndarray, chunk: int):
    """Host layout of K5's and K3's work: ``k1_work_items``'s items at
    ``chunk`` edges each, as ``(items, split_rows, split_items)``.

    ``items`` is (num_items, 4) int32, one row an item: the row (``~row``
    when the row spans several items), its first edge, its end, and the
    row's slot in ``split_rows`` (-1 when not split). ``split_rows`` (int64,
    ascending) are the rows of more than ``chunk`` edges and
    ``split_items`` (int32) the number of items of each.
    """
    indptr = np.asarray(indptr, np.int64)
    item_row, item_beg, split_rows = k1_work_items(indptr, chunk)
    deg = np.diff(indptr)
    row = item_row.astype(np.int64)
    end = np.minimum(item_beg.astype(np.int64) + chunk, indptr[1:][row])
    split = deg[row] > chunk
    slot = np.where(split, np.searchsorted(split_rows, row), -1)
    items = np.stack([np.where(split, ~row, row), item_beg, end, slot], 1).astype(np.int32)
    return items, split_rows, (-(-deg[split_rows] // chunk)).astype(np.int32)


def _k5_plan(csr: CSR, chunk: int, k: int):
    """K5's work items on the CSR's device, its split rows' tickets (zeros)
    and scratch rows ((split rows, k) of -inf), each made once per CSR and
    kept there: every launch leaves the tickets 0 and the scratch -inf, so
    K5's launches on one CSR stay ordered on one stream."""

    def make():
        items, split_rows, split_items = k5_work_items(csr.host_arrays()[0], chunk)
        dev = csr.device
        return (torch.from_numpy(items).to(dev), torch.from_numpy(split_items).to(dev),
                torch.zeros(split_rows.size, dtype=torch.int32, device=dev))

    items, split_items, tickets = csr.cached(f"k5_items_{chunk}", make)
    scratch = csr.cached(f"k5_scratch_{chunk}_{k}", lambda: torch.full(
        (split_items.numel(), k), float("-inf"), dtype=torch.float32, device=csr.device))
    return items, split_items, tickets, scratch


def segment_max_wide(csr: CSR, vals: torch.Tensor) -> torch.Tensor:
    """K5: ``out[d, k] = max over row d of vals[e, k]``, (N, K) f32, any K;
    empty rows give 0. ``vals`` is (capacity, K) in CSR order. Not
    differentiable: ``SegmentMaxWide`` is. One launch a call."""
    k = _check_wide(csr, vals)
    if vals.device.type == "cpu":
        return segment_max_wide_plain(csr, vals)

    lib = kernel_lib.load("segment_max_wide", _K5_SIGNATURES)
    dev = vals.device
    if csr.device != dev:
        raise ValueError(f"K5 needs the CSR and vals on one CUDA device, got {csr.device} and {dev}")
    n = csr.num_nodes
    out = torch.empty(n, k, dtype=torch.float32, device=dev)
    plane = vals.to(torch.float32).contiguous()
    if n == 0:
        return out
    chunk = K5_CHUNK
    items, split_items, tickets, scratch = _k5_plan(csr, chunk, k)
    rc = lib.stg_segment_max_wide(
        plane.data_ptr(),
        items.data_ptr(),
        items.shape[0],
        split_items.data_ptr(),
        split_items.numel(),
        tickets.data_ptr(),
        scratch.data_ptr(),
        out.data_ptr(),
        k,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K5 (segment_max_wide) launch failed with cudaError {rc}")
    segment_max_wide.launches += 1
    return out


segment_max_wide.launches = 0  # kernel launches since the count was last reset


class SegmentMaxWide(torch.autograd.Function):
    """``segment_max_wide`` with the JAX custom VJP's argmax-mask gradient
    (``segment_pallas.py:648-654``): ties double-count, an empty row passes
    nothing back, padding slots get 0."""

    @staticmethod
    def forward(ctx, vals, csr):
        out = segment_max_wide(csr, vals)
        ctx.csr = csr
        ctx.save_for_backward(vals, out)
        return out

    @staticmethod
    def backward(ctx, g):
        vals, out = ctx.saved_tensors
        return _max_edge_grad(ctx.csr, vals.float(), out, g).to(vals.dtype), None


def wide_stream_is_bf16(csr: CSR, vals: torch.Tensor) -> bool:
    """Whether the no-gather sum rounds ``vals`` to bf16: f32 values on a
    graph of at least ``WIDE_BF16_MIN_SLOTS`` edge slots."""
    return csr.capacity >= WIDE_BF16_MIN_SLOTS and vals.dtype == torch.float32


def segment_sum_wide_plain(csr: CSR, vals: torch.Tensor, edge_block: Optional[int] = None) -> torch.Tensor:
    """The no-gather sum's plain version: each value rounded to bf16 when
    ``wide_stream_is_bf16``, then a masked ``index_add`` over the real edges
    in f64, rounded once to f32 (the reference that the kernel's f32 sums
    approximate). ``edge_block`` bounds the temporaries."""
    k = _check_wide(csr, vals)
    dt = torch.bfloat16 if wide_stream_is_bf16(csr, vals) else vals.dtype
    e = int(csr.host_arrays()[0][-1])
    out = torch.zeros(csr.num_nodes, k, dtype=torch.float64, device=vals.device)
    block = max(e, 1) if edge_block is None else edge_block
    for e0 in range(0, e, block):
        e1 = min(e0 + block, e)
        out.index_add_(0, csr.rows[e0:e1].long(), vals[e0:e1].to(dt).double())
    return out.float()


def segment_sum_wide(csr: CSR, vals: torch.Tensor) -> torch.Tensor:
    """K1's no-gather mode: ``out[d, k] = sum over row d of vals[e, k]``,
    (N, K) f32, any K; empty rows give 0. ``vals`` is (capacity, K) in CSR
    order, rounded to bf16 when ``wide_stream_is_bf16``. Not
    differentiable: ``SegmentSumWide`` is."""
    k = _check_wide(csr, vals)
    if vals.device.type == "cpu":
        return segment_sum_wide_plain(csr, vals)

    lib = kernel_lib.load("segment_sum_wide", _WIDE_SUM_SIGNATURES)
    dev = vals.device
    if csr.device != dev:
        raise ValueError(f"the no-gather sum needs the CSR and vals on one CUDA device, got {csr.device} and {dev}")
    round_bf16 = wide_stream_is_bf16(csr, vals)
    n = csr.num_nodes
    # allocated first, so the poisoned-output checks find it in the block freed just before
    out = torch.empty(n, k, dtype=torch.float32, device=dev)
    plane = vals.to(torch.float32).contiguous()  # rounded to the stream in the kernel
    if n == 0:
        return out
    chunk = K1_CHUNK["nogather"]
    item_row, item_beg, split_rows = _work_items(csr, chunk)
    if split_rows.numel():
        out.index_fill_(0, split_rows, 0.0)
    rc = lib.stg_segment_sum_wide(
        csr.indptr.data_ptr(),
        plane.data_ptr(),
        int(round_bf16),
        item_row.data_ptr(),
        item_beg.data_ptr(),
        item_row.numel(),
        out.data_ptr(),
        k,
        chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"the no-gather sum (segment_sum_wide) launch failed with cudaError {rc}")
    segment_sum_wide.launches += 1
    return out


segment_sum_wide.launches = 0  # kernel launches since the count was last reset


class SegmentSumWide(SegmentSumNarrow):
    """``segment_sum_wide`` with the JAX custom VJP's destination gather
    (``segment_pallas.py:741-747``), ``SegmentSumNarrow``'s backward."""

    @staticmethod
    def forward(ctx, vals, csr):
        ctx.csr = csr
        return segment_sum_wide(csr, vals)
