"""K6 and K7: the row-id SpMM and the row-id degree over a flat dynamic edge
store, each with its wrapper and its plain PyTorch version.

A flat store is (rows, cols, w) of one capacity, "live-sorted": slots whose
row id is below ``num_nodes`` are in nondecreasing row order, and sentinel
slots (row id ``num_nodes``) may sit anywhere; tombstones keep their row id
and carry ``w = 0``. The lazy store's main arrays are such a store.

K6 (``spmm_rowid``, ``csrc/spmm_rowid.cu``) replaces
``stgraph_tpu/ops/segment_pallas.py``'s ``spmm_rowid_traced`` (``:1816``) and
its Pallas kernel ``_spmm_rowid_kernel`` (``:1673``) for one head:

    out[r, :] = sum_{slots e with rows[e] == r} w[e] * feats[cols[e], :]   (f32)

The port gathers ``feats[cols[e]]`` inside the kernel where the TPU kernel
took a pre-gathered (cap, F) plane, and needs no block metadata: a group of
lanes takes a fixed chunk of ``EDGE_CHUNK`` slots. Each output row is
written once: a first launch plans the chunks (``rowid_chunk_plan``: each
chunk's first and last row id, the only rows it may share with another
chunk, which it zeroes, and a bitmap of the rows that have a slot), the
second stores the runs of rows inside a chunk, adds the shared rows by
atomicAdd, and stores zeros in the rows the bitmap lacks (the design is in
the source).

K7 (``dyn_degree``, ``csrc/rowid_denom.cu``) replaces
``stgraph_tpu/ops/dyn_spmm.py``'s ``dyn_degree`` (``:436``) and its kernel
``_rowid_denom_kernel`` (``:382``): the per-row sum of ``w`` (or the count of
real slots when ``w`` is None), on K6's first edge-chunk design (runs
flushed by atomicAdd into a zeroed output) with one thread per run of
``DENOM_CHUNK`` slots. Neither kernel needs the block spans that
``segment_pallas.traced_block_meta`` (``:1626``) gives the TPU kernels.

Neither wrapper copies anything to the host: the store changes every
timestep on the device. Each takes the plain version only because the
tensor it was given lies on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from stgraph_tpu_torch.ops import kernel_lib

__all__ = [
    "DENOM_CHUNK",
    "EDGE_CHUNK",
    "dyn_degree",
    "dyn_degree_plain",
    "rowid_chunk_plan",
    "spmm_rowid",
    "spmm_rowid_plain",
    "spmm_rowid_with_plan",
]

EDGE_CHUNK = 256  # slots one K6 lane group takes
DENOM_CHUNK = 16  # slots one K7 thread takes

_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_K6_SIGNATURES = {
    "stg_rowid_chunk_plan": [_VP, _I64, _I, _I, _VP, _VP, _VP, _VP, _I, _VP],
    "stg_spmm_rowid": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I, _I, _I, _VP],
}
_K7_SIGNATURES = {"stg_rowid_denom": [_VP, _VP, _VP, ctypes.c_int64, _I, _I, _VP]}


def _check_store(rows: torch.Tensor, w: Optional[torch.Tensor], num_nodes: int, *others) -> None:
    if rows.dim() != 1:
        raise ValueError(f"rows must be (capacity,), got {tuple(rows.shape)}")
    for name, t in (("w", w),) + others:
        if t is not None and t.shape != rows.shape:
            raise ValueError(f"{name} must be (capacity={rows.shape[0]},), got {tuple(t.shape)}")
    if not 0 <= num_nodes < 2**31 - 1:
        raise ValueError(f"num_nodes {num_nodes} does not fit int32 row ids")


def spmm_rowid_plain(
    rows: torch.Tensor,
    cols: torch.Tensor,
    w: Optional[torch.Tensor],
    feats: torch.Tensor,
    num_nodes: int,
    edge_block: Optional[int] = None,
) -> torch.Tensor:
    """K6's plain version: gather, product, masked ``index_add``; f32 out.

    Slots whose row id is ``num_nodes`` or more count nothing. The products
    are f32, as the kernel forms them; the sums are taken in f64 and rounded
    once to f32, so the plain version is the reference that the kernel's
    (and the TPU kernel's) f32 sums approximate, whatever their order.
    ``edge_block`` bounds the (slots, F) temporaries; the result does not
    depend on it.
    """
    _check_store(rows, w, num_nodes, ("cols", cols))
    n = num_nodes
    cap = rows.shape[0]
    out = torch.zeros(n + 1, feats.shape[1], dtype=torch.float64, device=feats.device)
    block = max(cap, 1) if edge_block is None else edge_block
    for e0 in range(0, cap, block):
        r = rows[e0:e0 + block].long()
        live = r < n
        x = feats[cols[e0:e0 + block].long().clamp(max=max(n - 1, 0))].to(torch.float32)
        if w is not None:
            x = x * w[e0:e0 + block].to(torch.float32)[:, None]
        x = torch.where(live[:, None], x, 0.0)
        out.index_add_(0, torch.where(live, r, n), x.double())
    return out[:n].float()


def rowid_chunk_plan(rows: torch.Tensor, num_nodes: int, chunk: int = EDGE_CHUNK):
    """K6's chunk plan, its plain version, as ``(first, last, present)``.

    For each run of ``chunk`` slots, ``first`` and ``last`` hold the least
    and the greatest row id below ``num_nodes`` in it (tombstones count:
    they keep their row id), each (chunks,) int32, -1 for a chunk of
    sentinel slots only; in a live-sorted store only these two rows of a
    chunk can have slots in another chunk. ``present`` is the
    ((num_nodes + 31) // 32,) int32 bitmap of the rows that have a slot:
    bit ``r % 32`` of word ``r // 32``.
    """
    _check_store(rows, None, num_nodes)
    n, cap = num_nodes, rows.shape[0]
    chunks = -(-cap // chunk)
    r = torch.nn.functional.pad(rows.long(), (0, chunks * chunk - cap), value=n).view(chunks, chunk)
    real = r < n
    last = torch.where(real, r, -1).max(1).values
    first = torch.where(last >= 0, torch.where(real, r, n).min(1).values, -1)
    words = -(-n // 32)
    has = torch.zeros(words * 32, dtype=torch.int64, device=rows.device)
    has[rows.long()[rows.long() < n]] = 1
    bits = (has.view(words, 32) << torch.arange(32, device=rows.device)).sum(1)
    present = torch.where(bits >= 2**31, bits - 2**32, bits).int()  # the uint32 words' bits as int32
    return first.int(), last.int(), present


def spmm_rowid_with_plan(
    rows: torch.Tensor,
    cols: torch.Tensor,
    w: Optional[torch.Tensor],
    feats: torch.Tensor,
    num_nodes: int,
):
    """``spmm_rowid``, returning ``(out, first, last, present)``: the chunk
    plan the call made (``rowid_chunk_plan``'s on a CPU tensor), so that a
    check can hold the kernel's plan against its plain version."""
    _check_rowid_call(rows, cols, w, feats, num_nodes)
    if feats.device.type == "cpu":
        return (spmm_rowid_plain(rows, cols, w, feats, num_nodes), *rowid_chunk_plan(rows, num_nodes))
    return _spmm_rowid_cuda(rows, cols, w, feats, num_nodes)


def _check_rowid_call(rows, cols, w, feats, num_nodes) -> None:
    _check_store(rows, w, num_nodes, ("cols", cols))
    if feats.dim() != 2 or feats.shape[0] != num_nodes:
        raise ValueError(f"feats must be (num_nodes={num_nodes}, F), got {tuple(feats.shape)}")


def _spmm_rowid_cuda(rows, cols, w, feats, num_nodes):
    """K6's two launches on the card, as ``(out, first, last, present)``."""
    lib = kernel_lib.load("spmm_rowid", _K6_SIGNATURES)
    dev = feats.device
    if rows.device != dev or cols.device != dev or (w is not None and w.device != dev):
        raise ValueError("K6 needs the store and the features on one CUDA device")
    if rows.dtype != torch.int32 or cols.dtype != torch.int32:
        raise ValueError(f"K6 takes int32 rows and cols, got {rows.dtype} and {cols.dtype}")
    if feats.dtype != torch.float32 or (w is not None and w.dtype != torch.float32):
        raise ValueError("K6 streams f32 features and weights")
    n, f = feats.shape
    rows, cols, table = rows.contiguous(), cols.contiguous(), feats.contiguous()
    w = None if w is None else w.contiguous()
    cap = rows.numel()
    chunks = -(-cap // EDGE_CHUNK)
    out = torch.empty(n, f, dtype=torch.float32, device=dev)
    if n == 0 or f == 0 or cap == 0:
        return (out.zero_(), *rowid_chunk_plan(rows, n))
    first = torch.empty(chunks, dtype=torch.int32, device=dev)
    last = torch.empty(chunks, dtype=torch.int32, device=dev)
    present = torch.zeros(-(-n // 32), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.stg_rowid_chunk_plan(rows.data_ptr(), cap, n, EDGE_CHUNK, first.data_ptr(), last.data_ptr(),
                                  present.data_ptr(), out.data_ptr(), f, stream)
    if rc != 0:
        raise RuntimeError(f"K6 (spmm_rowid) chunk plan launch failed with cudaError {rc}")
    rc = lib.stg_spmm_rowid(
        rows.data_ptr(),
        cols.data_ptr(),
        None if w is None else w.data_ptr(),
        table.data_ptr(),
        first.data_ptr(),
        last.data_ptr(),
        present.data_ptr(),
        out.data_ptr(),
        cap,
        n,
        f,
        EDGE_CHUNK,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"K6 (spmm_rowid) launch failed with cudaError {rc}")
    spmm_rowid.launches += 1
    return out, first, last, present


def spmm_rowid(
    rows: torch.Tensor,
    cols: torch.Tensor,
    w: Optional[torch.Tensor],
    feats: torch.Tensor,
    num_nodes: int,
) -> torch.Tensor:
    """K6: ``out[r] = sum over the slots with row id r of w[e] * feats[cols[e]]``,
    (num_nodes, F) f32, over a live-sorted flat store.

    ``rows`` and ``cols`` are (capacity,) int32, ``w`` (capacity,) f32 or
    None (every real slot counts 1), ``feats`` (num_nodes, F) f32. One call
    is two launches (the chunk plan, then the sums) and counts one on
    ``spmm_rowid.launches``.
    """
    _check_rowid_call(rows, cols, w, feats, num_nodes)
    if feats.device.type == "cpu":
        return spmm_rowid_plain(rows, cols, w, feats, num_nodes)
    return _spmm_rowid_cuda(rows, cols, w, feats, num_nodes)[0]


spmm_rowid.launches = 0  # kernel launches since the count was last reset


def dyn_degree_plain(rows: torch.Tensor, w: Optional[torch.Tensor], num_nodes: int) -> torch.Tensor:
    """K7's plain version: a masked ``index_add`` in f64, rounded once to
    f32; (num_nodes,) per-row weight sums (live-slot counts for ``w=None``)."""
    _check_store(rows, w, num_nodes)
    n = num_nodes
    r = rows.long()
    live = r < n
    v = torch.ones(r.shape, dtype=torch.float64, device=rows.device) if w is None else w.double()
    den = torch.zeros(n + 1, dtype=torch.float64, device=rows.device)
    den.index_add_(0, torch.where(live, r, n), torch.where(live, v, 0.0))
    return den[:n].float()


def dyn_degree(rows: torch.Tensor, w: Optional[torch.Tensor], num_nodes: int) -> torch.Tensor:
    """K7: (num_nodes,) f32 per-row sum of ``w`` over a live-sorted flat
    store, or the count of real slots per row when ``w`` is None."""
    _check_store(rows, w, num_nodes)
    if rows.device.type == "cpu":
        return dyn_degree_plain(rows, w, num_nodes)

    lib = kernel_lib.load("rowid_denom", _K7_SIGNATURES)
    dev = rows.device
    if w is not None and (w.device != dev or w.dtype != torch.float32):
        raise ValueError("K7 takes f32 weights on the rows' device")
    if rows.dtype != torch.int32:
        raise ValueError(f"K7 takes int32 rows, got {rows.dtype}")
    n = num_nodes
    den = torch.zeros(n, dtype=torch.float32, device=dev)
    if n == 0 or rows.numel() == 0:
        return den
    rows = rows.contiguous()
    w = None if w is None else w.contiguous()
    rc = lib.stg_rowid_denom(
        rows.data_ptr(),
        None if w is None else w.data_ptr(),
        den.data_ptr(),
        rows.numel(),
        n,
        DENOM_CHUNK,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K7 (rowid_denom) launch failed with cudaError {rc}")
    dyn_degree.launches += 1
    return den


dyn_degree.launches = 0  # kernel launches since the count was last reset
