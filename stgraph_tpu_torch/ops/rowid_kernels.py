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
real slots when ``w`` is None, or of the slots with ``w > 0`` in its
indicator mode) in one launch: a warp a span of 256 slots,
read by coalesced 16 B loads, runs met by a segmented warp scan, spans
chained by a single-pass look-back (span ids from an atomic ticket), each
row's sum stored once and the rows without a slot zeroed in the same launch
(the design is in the source). Its look-back words and ticket are kept per device and stream
(``_k7_state``) and need no zeroing between launches. Neither kernel needs
the block spans that ``segment_pallas.traced_block_meta`` (``:1626``) gives
the TPU kernels.

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
from stgraph_tpu_torch.ops.spmm_kernels import _aligned16

__all__ = [
    "EDGE_CHUNK",
    "dyn_degree",
    "dyn_degree_plain",
    "rowid_chunk_plan",
    "spmm_rowid",
    "spmm_rowid_plain",
    "spmm_rowid_with_plan",
]

EDGE_CHUNK = 256  # slots one K6 lane group takes
_K7_SPAN = 256  # slots a K7 warp takes: the kernel's kP x 128 (csrc/rowid_denom.cu)

_VP = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_K6_SIGNATURES = {
    "stg_rowid_chunk_plan": [_VP, _I64, _I, _I, _VP, _VP, _VP, _VP, _I, _VP],
    "stg_spmm_rowid": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I64, _I, _I, _I, _I, _VP],
}
_K7_SIGNATURES = {"stg_rowid_denom": [_VP, _VP, _VP, _VP, _VP, _I64, _I, _I, _I, _VP]}
_K7_EPOCHS = 2**30  # the kernel's status words hold 2 epoch + 1 in an int32
# (device index, stream) -> [status (spans, 4) int32, ticket (1,) int32, epoch]
_K7_STATE: dict = {}


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
        x = feats[cols[e0:e0 + block].long().clamp(max=max(feats.shape[0] - 1, 0))].to(torch.float32)
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
    """The table may have more rows than the output (a shard's all-gathered
    table): it needs one for every column a live slot reads. On the CPU that
    is checked here; on the card the kernel checks each live column against
    the table's rows and fails the launch by a device-side assert, which
    costs no host sync."""
    _check_store(rows, w, num_nodes, ("cols", cols))
    if feats.dim() != 2:
        raise ValueError(f"feats must be a (rows, F) table, got {tuple(feats.shape)}")
    if feats.device.type == "cpu":
        live = cols[rows < num_nodes]
        if live.numel() and not 0 <= int(live.min()) <= int(live.max()) < feats.shape[0]:
            raise ValueError(f"a live slot reads column {int(live.min())} or {int(live.max())} of a table of "
                             f"{feats.shape[0]} rows")


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
    # n sizes the output and the plan and marks the sentinel; m, the table's
    # rows, bounds the live slots' columns (csrc/spmm_rowid.cu), so the table
    # may have more rows than the output
    n, m, f = num_nodes, min(feats.shape[0], 2**31 - 1), feats.shape[1]
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
        m,
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
    None (every real slot counts 1), ``feats`` (M, F) f32 with a row for
    every column a live slot reads (M may exceed ``num_nodes``: a shard's
    rows over the all-gathered table, ``parallel.dyn``); a live column
    outside ``[0, M)`` raises ``ValueError`` on the CPU and fails the
    launch by a device-side assert on the card. One call
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


def _k7_state(dev: torch.device, stream: int, spans: int):
    """K7's look-back words and ticket for ``stream`` on ``dev``, with room
    for ``spans`` spans, and this launch's epoch. Made (zeroed) on first use,
    when they must grow, and when the epochs run out; every launch leaves
    the ticket 0, and its words' epochs below the next launch's. K7's
    launches on one stream are ordered, so they can share them."""
    key = (dev.index, stream)
    state = _K7_STATE.get(key)
    if state is None or state[0].shape[0] < spans or state[2] + 1 >= _K7_EPOCHS:
        size = max(spans, 0 if state is None else state[0].shape[0])
        state = [torch.zeros(1 << (size - 1).bit_length(), 4, dtype=torch.int32, device=dev),
                 torch.zeros(1, dtype=torch.int32, device=dev), 0]
        _K7_STATE[key] = state
    state[2] += 1
    return state


def dyn_degree(rows: torch.Tensor, w: Optional[torch.Tensor], num_nodes: int, indicator: bool = False) -> torch.Tensor:
    """K7: (num_nodes,) f32 per-row sum of ``w`` over a live-sorted flat
    store, or the count of real slots per row when ``w`` is None; with
    ``indicator`` the count of the slots whose ``w`` is above 0 (the sum of
    ``torch.where(w > 0, 1.0, 0.0)``, without making it). One launch."""
    _check_store(rows, w, num_nodes)
    if indicator and w is None:
        raise ValueError("dyn_degree's indicator mode counts w > 0: it needs w")
    if rows.device.type == "cpu":
        return dyn_degree_plain(rows, torch.where(w > 0, 1.0, 0.0) if indicator else w, num_nodes)

    dev = rows.device
    if w is not None and (w.device != dev or w.dtype != torch.float32):
        raise ValueError("K7 takes f32 weights on the rows' device")
    if rows.dtype != torch.int32:
        raise ValueError(f"K7 takes int32 rows, got {rows.dtype}")
    n, cap = num_nodes, rows.numel()
    if n == 0 or cap == 0:
        return torch.zeros(n, dtype=torch.float32, device=dev)
    return _dyn_degree_into(rows, w, n, indicator, torch.empty(n, dtype=torch.float32, device=dev))


def _dyn_degree_into(rows, w, n, indicator, den):
    """K7's launch into ``den`` ((n,) f32 on the card, whatever it holds:
    the kernel writes every element); ``dyn_degree`` checked the rest."""
    lib = kernel_lib.load("rowid_denom", _K7_SIGNATURES)
    dev = rows.device
    cap = rows.numel()
    if den.shape != (n,) or den.dtype != torch.float32 or den.device != dev or not den.is_contiguous():
        raise ValueError(f"K7's output must be ({n},) contiguous f32 on {dev}")
    rows = _aligned16(rows)
    w = None if w is None else _aligned16(w)
    stream = torch.cuda.current_stream(dev).cuda_stream
    spans = -(-cap // _K7_SPAN)
    status, ticket, epoch = _k7_state(dev, stream, spans)
    rc = lib.stg_rowid_denom(
        rows.data_ptr(),
        None if w is None else w.data_ptr(),
        den.data_ptr(),
        status.data_ptr(),
        ticket.data_ptr(),
        cap,
        n,
        0 if w is None else (2 if indicator else 1),
        epoch,
        stream,
    )
    if rc != 0:
        raise RuntimeError(f"K7 (rowid_denom) launch failed with cudaError {rc}")
    dyn_degree.launches += 1
    return den


dyn_degree.launches = 0  # kernel launches since the count was last reset
