"""K10: the multi-head weighted segment sum over the blocked layout, with its
wrapper, its plain PyTorch version and the multi-head SpMM built on it.

Counterpart of the blocked half of ``stgraph_tpu/ops/spmm_pallas.py``:
``segment_sum_blocked`` (``:139-211``) and its Pallas kernel
``_seg_matmul_kernel`` (``:61``), ``_gather_scale_segment_sum``
(``:241-299``), ``_make_spmm_multihead`` (``:357-401``),
``_to_blocked_w_mh`` (``:404-417``) and ``_ensure_blocked`` (``:669-689``):

    out[d, c] = sum_{slots s, dst[s] == d} w[s, c // F] * feats[cols[s], c]

over the (N, H * F) table, f32, with ``w`` (CB, H) in blocked slot order.
Sentinel slots add nothing. The JAX package gathered ``feats[cols]`` and
scaled it before its kernel (Mosaic cannot gather inside a kernel); the
CUDA kernel (``csrc/segment_sum_blocked.cu``) gathers inside, so no (CB,
H * F) plane exists (507 GB at ogbn-products size and H * F = 1024). It
walks a host-built list of work items (``k10_work_items``: a slot range of
one row, at most ``K10_CHUNK`` slots, built once per layout and kept with
it), one warp an item holding a panel of at most ``K10_PANEL`` columns of
one head (``k10_panels``), and stores each row once: only rows split over
several items are zeroed and meet by atomicAdd. On this card it is bound
by memory: the compulsory bytes give about 7 ms at that size, the gathered
rows about 25 times more, and a head's panel keeps the slice it gathers
from in L2 where the table is small enough (PPI size). A head narrower
than a warp's piece of columns leaves lanes idle (``k10_panels``).

``SpmmMultihead`` is ``_make_spmm_multihead``: K10 forward on ``blocked``,
``d feat`` by K10 on the transpose layout ``blocked_t`` with the weights
carried through the shared user edge ids, and ``d w`` by the per-head
SDDMM in plain torch, as the JAX package computes it in ``jnp``. The
composed GAT route (``ops.attention``) and ``ops.message.spmm``'s
multi-head sums use them for head tilings the row-wise kernel's multi-head
mode would not take (``_rowmask_eligible`` false).

The wrapper takes the plain version only because the tensor it was given
lies on the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from stgraph_tpu_torch.graph.blocked import ROW_BLOCK, BlockedCSR, blocked_layout
from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import kernel_lib
from stgraph_tpu_torch.ops.spmm_kernels import k1_work_items

__all__ = [
    "K10_CHUNK",
    "K10_PANEL",
    "SpmmMultihead",
    "k10_panels",
    "k10_work_items",
    "per_head_sddmm",
    "positions_in",
    "rowmask_eligible",
    "segment_sum_blocked",
    "segment_sum_blocked_plain",
    "spmm_multihead",
]

# Slots of one row one warp takes; a longer row is split into several work
# items whose partial sums meet by atomicAdd.
K10_CHUNK = 256
# The most columns of one head a K10 warp holds. Measured on an H100
# (PERF.md §6) at the GAT paper's PPI widths on the PPI and ogbn-products
# graphs: 128 as fast as 64 or faster, and faster than 256; panels of up
# to 1024 columns across the whole row were slower at every one of them.
K10_PANEL = 128
# Edges per block of the plain per-head products: bounds each (edges, H*F)
# f32 temporary to about 1 GB.
_PLANE_ELEMS = 1 << 28

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stg_segment_sum_blocked": [_VP, _VP, _VP, _I, _VP, _VP, ctypes.c_int64, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
}


def rowmask_eligible(heads: int, f: int) -> bool:
    """The JAX package's ``_rowmask_eligible`` (``spmm_pallas.py:579-584``):
    the tilings the row-wise kernel's multi-head mode takes. The others go to
    the blocked kernel K10."""
    return heads == 1 or (128 % f == 0 and (heads * f) % 128 == 0)


def _check(blocked: BlockedCSR, w_blocked: torch.Tensor, feats: torch.Tensor, heads: int) -> int:
    if feats.dim() != 2 or feats.shape[0] != blocked.num_nodes:
        raise ValueError(f"feats must be (num_nodes={blocked.num_nodes}, H*F), got {tuple(feats.shape)}")
    hf = feats.shape[1]
    if heads < 1 or hf % heads:
        raise ValueError(f"feature width {hf} is not a multiple of heads={heads}")
    if tuple(w_blocked.shape) != (blocked.capacity, heads):
        raise ValueError(f"w_blocked must be (slots={blocked.capacity}, heads={heads}), got {tuple(w_blocked.shape)}")
    return hf // heads


def segment_sum_blocked_plain(
    blocked: BlockedCSR,
    w_blocked: torch.Tensor,
    feats: torch.Tensor,
    heads: int,
    edge_block: Optional[int] = None,
) -> torch.Tensor:
    """K10's plain version: gather the real slots' rows, scale each column by
    its head's weight, ``index_add`` into the destinations; the products in
    f32 as the kernel forms them, each row's sum in f64 rounded once to f32.

    ``edge_block`` bounds the temporaries: the real slots, which the layout
    keeps in destination order, are taken that many at a time, each block
    summed in f64 over its own rows only, and a row that runs on into the
    next block carries its f64 partial sum there. The result does not
    depend on it.
    """
    f = _check(blocked, w_blocked, feats, heads)
    n, hf = feats.shape
    real = torch.nonzero(blocked.dst < n).reshape(-1)
    dst = blocked.dst[real].long()
    out = torch.zeros(n, hf, dtype=torch.float32, device=feats.device)
    m = real.numel()
    block = max(m, 1) if edge_block is None else edge_block
    x32 = feats.to(torch.float32)
    carry = None  # the f64 partial sum of a row that runs on into the next block
    for s0 in range(0, m, block):
        s, d = real[s0:s0 + block], dst[s0:s0 + block]
        r0, r1 = int(d[0]), int(d[-1]) + 1
        w = w_blocked[s].to(torch.float32).repeat_interleave(f, dim=1)
        acc = torch.zeros(r1 - r0, hf, dtype=torch.float64, device=feats.device)
        acc.index_add_(0, d - r0, (x32[blocked.cols[s].long()] * w).double())
        if carry is not None:
            acc[0] += carry  # the carried row is r0: the slots are in destination order
        carry = acc[-1].clone() if s0 + block < m and int(dst[s0 + block]) == r1 - 1 else None
        done = r1 - 1 if carry is not None else r1
        out[r0:done] = acc[: done - r0].float()
    return out


def k10_work_items(indptr: np.ndarray, offsets: np.ndarray, chunk: int = K10_CHUNK):
    """Host layout of K10's work over a blocked layout: ``k1_work_items``'s
    items, moved to slot positions in the layout.

    Row ``d`` of block ``b = d // ROW_BLOCK`` owns the ``deg(d)`` slots from
    ``offsets[b] + indptr[d] - indptr[ROW_BLOCK * b]`` on (a block's slots
    are in CSR order). Each row gets ``max(1, ceil(deg / chunk))`` items of
    at most ``chunk`` slots, in row order; an empty row gets one empty item,
    whose warp stores zeros.

    Returns ``(item_row, item_beg, item_end, split_rows)``: int32 arrays of
    each item's row (``~d`` for a row that spans several items), first slot
    and end slot, and the split rows (int64), which the wrapper zeroes
    before the kernel accumulates into them.
    """
    indptr = np.asarray(indptr, np.int64)
    offsets = np.asarray(offsets, np.int64)
    item_row, beg, split_rows = k1_work_items(indptr, chunk)
    block = item_row.astype(np.int64) // ROW_BLOCK
    shift = offsets[block] - indptr[block * ROW_BLOCK]  # CSR position -> slot in the layout
    beg = beg.astype(np.int64)
    item_beg = beg + shift
    item_end = np.minimum(beg + chunk, indptr[1:][item_row]) + shift
    split = np.zeros(indptr.shape[0] - 1, bool)
    split[split_rows] = True
    coded = np.where(split[item_row], ~item_row, item_row)
    return coded.astype(np.int32), item_beg.astype(np.int32), item_end.astype(np.int32), split_rows


def k10_panels(f: int, hf: int, align: int = 16) -> Tuple[int, int, int]:
    """How K10's warps hold a row, as ``(v, pieces, per_head)``: a lane loads
    ``v`` columns at once (4, 2 or 1: the most that divides ``hf`` and whose
    ``4 * v`` bytes divide ``align``, the alignment of the table and the
    output), a warp holds ``pieces`` pieces of ``32 * v`` columns of one
    head (a power-of-two count, at most ``K10_PANEL`` columns), and a head
    takes ``per_head`` such panels from its first column rounded down to
    ``v``: where ``F % v != 0`` (6 x 121, 6 x 47) the loads stay aligned and
    a lane keeps its columns inside the head.

    A head narrower than a piece leaves most lanes idle, and every head
    walks its slots once: at 17 x 8 on the PPI graph K10 takes 3.3 times
    the time of its first design, which walked 128-column tiles of the
    whole row (PERF.md §7).
    """
    v = next(v for v in (4, 2, 1) if hf % v == 0 and align % (4 * v) == 0)
    span = f + v - 1 if f % v else f  # the columns from the head's first rounded down to v
    need = -(-min(K10_PANEL, span) // (32 * v))
    pieces = 1 << (need - 1).bit_length()
    return v, pieces, -(-span // (pieces * 32 * v))


def _work_items(blocked: BlockedCSR):
    """``k10_work_items`` of ``blocked``, on its device, built once."""

    def make():
        if blocked.capacity + K10_CHUNK >= 2**31:
            raise ValueError("K10 indexes slots with int32; the layout is too large")
        arrays = k10_work_items(blocked.host_indptr, blocked.host_offsets, K10_CHUNK)
        return tuple(torch.from_numpy(a).to(blocked.device) for a in arrays)

    return blocked.cached(f"k10_items_{K10_CHUNK}", make)


def segment_sum_blocked(blocked: BlockedCSR, w_blocked: torch.Tensor, feats: torch.Tensor, heads: int) -> torch.Tensor:
    """K10: ``out[d, c] = sum over d's slots of w[s, c // F] * feats[cols[s], c]``,
    (N, H*F) f32. ``w_blocked`` is (CB, heads) in blocked slot order,
    ``feats`` (N, H*F). Not differentiable: ``SpmmMultihead`` is."""
    _check(blocked, w_blocked, feats, heads)
    if feats.device.type == "cpu":
        return segment_sum_blocked_plain(blocked, w_blocked, feats, heads)

    lib = kernel_lib.load("segment_sum_blocked", _SIGNATURES)
    dev = feats.device
    if blocked.device != dev or w_blocked.device != dev:
        raise ValueError(f"K10 needs the layout, weights and features on one CUDA device, got "
                         f"{blocked.device}, {w_blocked.device} and {dev}")
    n, hf = feats.shape
    # allocated first, so the poisoned-output checks find it in the block freed just before
    out = torch.empty(n, hf, dtype=torch.float32, device=dev)
    if n == 0 or hf == 0:
        return out
    table = feats.to(torch.float32).contiguous()
    w = w_blocked.to(torch.float32).t().contiguous()  # head-major: (heads, CB)
    v, pieces, per_head = k10_panels(hf // heads, hf, math.gcd(table.data_ptr(), out.data_ptr(), 16))
    item_row, item_beg, item_end, split_rows = _work_items(blocked)
    if split_rows.numel():
        out.index_fill_(0, split_rows, 0.0)
    rc = lib.stg_segment_sum_blocked(
        item_row.data_ptr(),
        item_beg.data_ptr(),
        item_end.data_ptr(),
        item_row.numel(),
        blocked.cols.data_ptr(),
        w.data_ptr(),
        blocked.capacity,
        table.data_ptr(),
        out.data_ptr(),
        hf,
        hf // heads,
        heads,
        v,
        pieces,
        per_head,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K10 (segment_sum_blocked) launch failed with cudaError {rc}")
    segment_sum_blocked.launches += 1
    return out


segment_sum_blocked.launches = 0  # kernel launches since the count was last reset


def positions_in(csr: CSR, eids: torch.Tensor) -> torch.Tensor:
    """The position in ``csr``'s edge order of each user edge id in ``eids``
    (int32); the sentinel ``capacity`` maps to some padding slot. With the
    transpose's ``eids`` this is ``perm_t``: ``v[perm_t]`` is forward-order
    ``v`` in transpose order."""
    cap = csr.capacity

    def make():
        pos = torch.zeros(cap + 1, dtype=torch.int32, device=csr.device)
        arange = torch.arange(cap, dtype=torch.int32, device=csr.device)
        return pos.index_copy_(0, csr.eids.long().clamp(max=cap), arange)

    return csr.cached("pos_in_csr", make)[eids.long().clamp(max=cap)]


def _to_blocked_w_mh(blk: BlockedCSR, csr: CSR, w: torch.Tensor) -> torch.Tensor:
    """(capacity, H) CSR-order weights of ``csr`` in ``blk``'s slot order,
    carried through the shared user edge ids (slot -> eid -> position in
    ``csr``). For ``csr``'s own layout that is ``blk.perm``; for its
    transpose's, each transpose slot takes its edge's forward weights.
    Sentinel slots pick up some weight, which K10 never reads."""
    return w.index_select(0, positions_in(csr, blk.eids))


def _ensure_blocked(
    csr: CSR, blocked: Optional[BlockedCSR], blocked_t: Optional[BlockedCSR], csr_t: Optional[CSR]
) -> Tuple[BlockedCSR, BlockedCSR]:
    """The forward and transpose blocked layouts, built (once per CSR) where
    the caller has none."""
    if blocked is None:
        blocked = blocked_layout(csr)
    if blocked_t is None:
        blocked_t = blocked_layout(csr_t if csr_t is not None else csr.transpose())
    return blocked, blocked_t


def per_head_sddmm(csr: CSR, a: torch.Tensor, b: torch.Tensor, heads: int) -> torch.Tensor:
    """``dw[e, h] = sum_f a[src_e, h, f] * b[dst_e, h, f]`` on the flattened
    (N, H*F) tables, (capacity, H) f32 in ``csr``'s edge order, 0 on padding
    slots: the JAX package's plain ``jnp`` SDDMM, taken in edge blocks."""
    hf = a.shape[1]
    e = int(csr.host_arrays()[0][-1])
    dw = torch.zeros(csr.capacity, heads, dtype=torch.float32, device=a.device)
    block = max(1, _PLANE_ELEMS // max(hf, 1))
    for e0 in range(0, e, block):
        e1 = min(e0 + block, e)
        prod = a[csr.cols[e0:e1].long()].float() * b[csr.rows[e0:e1].long()].float()
        dw[e0:e1] = prod.reshape(e1 - e0, heads, hf // heads).sum(-1)
    return dw


class SpmmMultihead(torch.autograd.Function):
    """``_make_spmm_multihead``: K10 forward on ``blocked``; ``d feat`` by K10
    on ``blocked_t`` and ``d w`` by the per-head SDDMM."""

    @staticmethod
    def forward(ctx, h, w, csr, blocked, blocked_t):
        n, heads, f = h.shape
        out = segment_sum_blocked(blocked, _to_blocked_w_mh(blocked, csr, w), h.reshape(n, heads * f), heads)
        ctx.csr, ctx.blocked_t = csr, blocked_t
        ctx.save_for_backward(h, w)
        return out.reshape(n, heads, f)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        csr = ctx.csr
        n, heads, f = h.shape
        g2 = g.reshape(n, heads * f).float()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            wb_t = _to_blocked_w_mh(ctx.blocked_t, csr, w)
            dh = segment_sum_blocked(ctx.blocked_t, wb_t, g2, heads).reshape(n, heads, f).to(h.dtype)
        if ctx.needs_input_grad[1]:
            dw = per_head_sddmm(csr, h.reshape(n, heads * f), g2, heads).to(w.dtype)
        return dh, dw, None, None, None


def spmm_multihead(csr: CSR, node_feat: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[d, h] = sum_e w[e, h] * node_feat[src_e, h]`` for (N, H, F)
    features and (capacity, H) CSR-order weights, through K10 on the blocked
    layouts of ``csr`` and of its transpose (built once per CSR); (N, H, F)
    f32."""
    blocked, blocked_t = _ensure_blocked(csr, None, None, None)
    return SpmmMultihead.apply(node_feat, w.reshape(csr.capacity, -1), csr, blocked, blocked_t)
