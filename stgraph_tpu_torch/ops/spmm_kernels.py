"""K1 and K2: the row-wise SpMM kernel and its fused backward, each with its
wrapper and its plain PyTorch version.

Replaces ``stgraph_tpu/ops/segment_pallas.py``'s ``spmm_rowmask``
(``:913-1133``) and its Pallas kernel ``_spmm_rowmask_kernel`` (``:761``),
for one head or ``heads`` heads of F columns each, with the softmax
denominator when asked:

    out[d, c] = sum_{e in row d} w[e, c // F] * node_feats[cols[e], c]   (f32)
    den[d, h] = sum_{e in row d} w[e, h]                                 (f32)

Several heads need the JAX package's tiling (``:945-958``): ``128 % F == 0``
and ``(H * F) % 128 == 0``; any other raises ``ValueError``, as there.

The CUDA kernel lives in ``csrc/spmm_rowmask.cu``. On this card it is bound
by memory: two operations per gathered element, and the gathered rows are
spread over a table far larger than L2. Its bound is the compulsory bytes
(``indptr``, ``cols``, ``w``, the input table read once, the output written
once) over the card's memory rate; at ogbn-products size (E = 123.7M,
F = 128) that is about 1 ms on an H100 SXM, while the gathered traffic is
about 25 times more. The design (a warp per work item, a group of lanes an
edge so a warp takes several edges a step, the gather inside the kernel, a
bf16 table made once, hub rows split across warps) is described in the
source; the host plans it here: the work items (``k1_work_items``, at most
``K1_CHUNK[mode]`` edges an item) and the lane groups and column tiles
(``k1_lanes``).

K2 (``spmm_rowmask_bwd``, ``csrc/spmm_sddmm_rowmask.cu``) replaces
``segment_pallas.spmm_rowmask_bwd`` (``:1434-1618``) and its Pallas kernel
``_spmm_sddmm_rowmask_kernel`` (``:1248``) for one head. On the transpose
CSR, with the weights in transpose edge order, one pass gives

    dh[s, :] = sum_{e in row s} w_t[e] * g[cols_t[e], :]            (f32)
    dw_t[e]  = < fs[s, :], g[cols_t[e], :] >     (f32, 0 on padding slots)

It takes K1's design (work items on the transpose ``indptr``, at most
``K2_CHUNK[mode]`` edges an item, and K1's lane groups, ``k1_lanes``) with
the dot products folded in, and its bound is the same kind: memory, about
1.6 ms at ogbn-products size and F = 128. With ``heads`` heads
(``:1434-1560``) ``w_t`` and ``dw_t`` are (capacity, H) and each head's
columns form their own dot product.

Every wrapper takes a rectangular CSR (``graph.csr``): the table has
``csr.num_cols`` rows and the output ``csr.num_nodes``; a square CSR is the
case ``num_cols == num_nodes``.

``spmm_rowmask_traced`` is K1's shard mode, the counterpart of
``segment_pallas.spmm_rowmask_traced`` (``:1136``, ``pallas_call`` at
``:1223``), which the distribution layer (``parallel/halo.py``) runs on each
shard's interior, frontier and local CSRs. On the TPU it is a kernel apart:
Mosaic cannot gather, so the caller pre-gathers a (cap_pad, H * F) plane
(31.7 GB at ogbn-products size, F = 64, in f32) and passes the shard's
block metadata as traced values. Here it is K1 itself, on the same C entry:
the gather is inside the kernel and the work items, made once per shard CSR
on the host, take the place of the traced metadata. What makes it a mode is
the contract: the stream is the table's dtype (f32 unless the table is
bf16), never the large-graph bf16 rule of ``spmm_cuda``, as JAX's traced
kernel streams the gathered dtype (``:1173-1175``), and its launches count
apart (``spmm_rowmask_traced.launches``).

Each wrapper takes the plain version only because the tensor it was given
lies on the CPU. For a CUDA tensor it launches the kernel or raises;
nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import kernel_lib

__all__ = [
    "FLASH_CHUNK",
    "K1_CHUNK",
    "K2_CHUNK",
    "ROW_CHUNK",
    "k1_lanes",
    "k1_work_items",
    "spmm_rowmask",
    "spmm_rowmask_bwd",
    "spmm_rowmask_bwd_plain",
    "spmm_rowmask_plain",
    "spmm_rowmask_traced",
]

# Edges one warp takes from a row; longer rows are split into several work
# items whose partial sums meet by atomicAdd. K3 takes items of ROW_CHUNK
# edges; K1, K2, K4, K5, K8 and K9 take their own lengths (K1_CHUNK,
# K2_CHUNK, segment_kernels.K4_CHUNK and K5_CHUNK, FLASH_CHUNK).
ROW_CHUNK = 1024
# K1's item length by mode: "one_head" (the GCN paths and the shard mode),
# "heads" (heads > 1, with the denominator) and "nogather" (the no-gather
# sum, ops.segment_kernels.segment_sum_wide).
K1_CHUNK = {"one_head": 1024, "heads": 128, "nogather": 128}
# K2's item length by mode: "one_head" (the GCN step) and "heads" (the
# rowmask route's backward).
K2_CHUNK = {"one_head": 512, "heads": 128}
# K8's ("fwd") and K9's ("bwd", on the transpose CSR) item lengths
# (ops.flash_gat).
FLASH_CHUNK = {"fwd": 512, "bwd": 512}

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stg_spmm_rowmask": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
    "stg_bf16_product_check": [ctypes.c_ulonglong, ctypes.c_ulonglong, _VP, _VP],
}
_K2_SIGNATURES = {
    "stg_spmm_sddmm_rowmask": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP],
}

_INT32_LIMIT = 2**31


def k1_work_items(indptr: np.ndarray, chunk: int = ROW_CHUNK):
    """Host layout of K1's work: one item per row, and ``ceil(deg/chunk)``
    items for a row of more than ``chunk`` edges.

    Returns ``(item_row, item_beg, split_rows)``: the row and first edge of
    each item (int32), and the rows that span several items (int64), which
    the wrapper zeroes before the kernel accumulates into them.
    """
    indptr = np.asarray(indptr, np.int64)
    deg = np.diff(indptr)
    k = np.maximum(1, -(-deg // chunk))
    item_row = np.repeat(np.arange(deg.shape[0], dtype=np.int32), k)
    first = np.cumsum(k) - k
    item_beg = indptr[:-1][item_row] + (np.arange(item_row.shape[0]) - first[item_row]) * chunk
    split_rows = np.flatnonzero(deg > chunk).astype(np.int64)
    return item_row, item_beg.astype(np.int32), split_rows


def k1_lanes(f: int, elem_bytes: int, aligned: bool) -> Tuple[int, int]:
    """How K1's warps cover a row of ``f`` columns, as ``(g, tile)``: ``g``
    lanes take one edge, one 16 B load each (``16 / elem_bytes`` columns),
    so a warp takes ``32 // g`` edges a step; blockIdx.y walks tiles of
    ``tile`` columns (the whole row when it fits in a warp's 512 B).

    ``aligned`` says that every row starts on 16 B (the row stride a
    multiple of the lane's columns and the table aligned). Otherwise (f32
    only) a group reads the row from its start rounded down to 16 B, so a
    tile of ``t`` columns spans up to ``t + 3``: tiles of at most 124
    columns keep that within 32 lanes. ``g`` is the tile's 16 B pieces
    rounded up to a power of two.
    """
    v = 16 // elem_bytes
    if aligned:
        tile = f if f <= 32 * v else 32 * v
        pieces = -(-tile // v)
    else:
        if v != 4:
            raise ValueError("only an f32 table may have rows that are not 16 B aligned")
        tile = f if f + 3 <= 128 else 124
        pieces = -(-(tile + 3) // 4)
    return 1 << (max(pieces, 1) - 1).bit_length(), tile


def _head_width(width: int, heads: int, kernel: str) -> int:
    """F of a (N, heads * F) table, checked against the JAX package's tiling
    rule for several heads (``segment_pallas.py:945-958``)."""
    f = width // heads if heads >= 1 else 0
    if f < 1 or f * heads != width:
        raise ValueError(f"node_feats width {width} must be heads * F with heads={heads}")
    if heads > 1 and (128 % f != 0 or width % 128 != 0):
        raise ValueError(f"multihead {kernel} needs 128 % F == 0 and heads*F % 128 == 0, got heads={heads}, F={f}")
    return f


def _stream_is_bf16(node_feats: torch.Tensor, stream_dtype) -> bool:
    if stream_dtype is not None:
        if stream_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported stream dtype {stream_dtype}")
        return stream_dtype == torch.bfloat16
    return node_feats.dtype == torch.bfloat16


def spmm_rowmask_plain(
    csr: CSR,
    w: Optional[torch.Tensor],
    node_feats: torch.Tensor,
    stream_dtype=None,
    edge_block: Optional[int] = None,
    heads: int = 1,
    with_denom: bool = False,
):
    """K1's plain version: gather, product, masked ``index_add_``; f32 out.

    Only the real edges (positions below ``indptr[n]``) are summed. The
    products are rounded as the kernel rounds them: with a bf16 stream the
    gathered features and the weights are bf16 and their product is rounded
    to bf16. The sum is taken in f64 and rounded once to f32, so the plain
    version is the reference that the kernel's (and the TPU kernel's) f32
    sums approximate, whatever their order. Differentiable by autograd.

    With ``heads`` heads ``w`` is (capacity, heads) and column ``c`` takes
    the weight of head ``c // F``. ``with_denom`` returns ``(out, den)``,
    ``den`` (N, heads) the f64 sum of the unrounded weights rounded to f32;
    otherwise ``out`` alone.

    ``edge_block`` bounds the (edges, F) temporaries: rows are taken in
    groups of about that many edges (at ogbn-products size one group of
    all edges would need some 63 GB). The result does not depend on it.

    ``node_feats`` is the table the columns index (``csr.num_cols`` rows);
    the output has ``csr.num_nodes`` rows.
    """
    n, width = csr.num_nodes, node_feats.shape[1]
    f = _head_width(width, heads, "spmm_rowmask")
    if with_denom and w is None:
        raise ValueError("with_denom requires weights")
    indptr = csr.host_arrays()[0]
    e = int(indptr[-1])
    bf16 = _stream_is_bf16(node_feats, stream_dtype)
    block = max(e, 1) if edge_block is None else edge_block
    firsts = np.searchsorted(indptr, np.arange(0, e, block), side="right") - 1
    starts = np.unique(np.concatenate([[0], firsts]))
    bounds = list(starts[starts < n]) + [n]
    dev = node_feats.device
    w2 = None if w is None else w.reshape(csr.capacity, heads)
    parts, dens = [], []
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        rows = csr.rows[e0:e1].long() - r0
        x = node_feats[csr.cols[e0:e1].long()].to(torch.bfloat16 if bf16 else torch.float32)
        if w2 is None:
            msg = x.float()
        else:
            wt = w2[e0:e1].to(torch.float32)
            if heads > 1:
                wt = wt.repeat_interleave(f, dim=1)
            if bf16:
                msg = (x.float() * wt.to(torch.bfloat16).float()).to(torch.bfloat16).float()
            else:
                msg = x * wt
            if with_denom:
                den = torch.zeros(r1 - r0, heads, dtype=torch.float64, device=dev)
                dens.append(den.index_add(0, rows, w2[e0:e1].double()).float())
        out = torch.zeros(r1 - r0, width, dtype=torch.float64, device=dev)
        parts.append(out.index_add(0, rows, msg.double()).float())
    if not parts:
        out = torch.zeros(n, width, dtype=torch.float32, device=dev)
        return (out, torch.zeros(n, heads, device=dev)) if with_denom else out
    out = parts[0] if len(parts) == 1 else torch.cat(parts)
    return (out, torch.cat(dens)) if with_denom else out


def _work_items(csr: CSR, chunk: int = ROW_CHUNK):
    """``k1_work_items`` of ``csr`` at ``chunk`` edges an item, on its
    device, built once per chunk length."""

    def make():
        item_row, item_beg, split_rows = k1_work_items(csr.host_arrays()[0], chunk)
        dev = csr.device
        return (
            torch.from_numpy(item_row).to(dev),
            torch.from_numpy(item_beg).to(dev),
            torch.from_numpy(split_rows).to(dev),
        )

    return csr.cached(f"k1_items_{chunk}", make)


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous), copied where its data does not start on 16 B."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _gathered_table(csr: CSR, feats: torch.Tensor, stream_dtype, kernel: str):
    """The table a kernel gathers rows from, as ``(table, ld, bf16)``: the
    features themselves for an f32 stream, or a bf16 copy whose row stride
    ``ld`` is padded to a multiple of 8 (16 B: aligned vector loads at any
    F). Checks device, type and the int32 index range."""
    dev = feats.device
    if dev.type != "cuda" or csr.device != dev:
        raise ValueError(
            f"{kernel} needs the CSR and the features on one CUDA device, got {csr.device} and {dev}"
        )
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{kernel} takes f32 or bf16 features, got {feats.dtype}")
    n, f = feats.shape
    bf16 = _stream_is_bf16(feats, stream_dtype)
    if bf16:
        ld = -(-f // 8) * 8
        table = feats.to(torch.bfloat16)
        table = F.pad(table, (0, ld - f)) if ld != f else _aligned16(table)
    else:
        if feats.dtype != torch.float32:
            raise ValueError("an f32 stream needs f32 features")
        ld = f
        table = feats.contiguous()
    if n * ld >= _INT32_LIMIT or csr.capacity + ROW_CHUNK >= _INT32_LIMIT:
        raise ValueError(f"{kernel} indexes rows and edges with int32; the graph is too large")
    return table, ld, bf16


def _edge_weights(w: torch.Tensor, dev: torch.device) -> torch.Tensor:
    if w.device != dev:
        raise ValueError("w must be on the features' device")
    return w.reshape(-1).to(torch.float32).contiguous()


def _check_k1(csr: CSR, w: Optional[torch.Tensor], node_feats: torch.Tensor, heads: int, with_denom: bool) -> None:
    if node_feats.dim() != 2 or node_feats.shape[0] != csr.num_cols:
        raise ValueError(
            f"node_feats must be (num_cols={csr.num_cols}, F), got {tuple(node_feats.shape)}"
        )
    _head_width(node_feats.shape[1], heads, "spmm_rowmask")
    if w is not None and w.numel() != csr.capacity * heads:
        raise ValueError(f"w must hold {heads} weight(s) per edge slot ({csr.capacity} slots)")
    if with_denom and w is None:
        raise ValueError("with_denom requires weights")


def _launch_k1(counter, csr, w, node_feats, heads, with_denom, stream_dtype):
    """K1 on the card, adding one to ``counter.launches`` when it launches."""
    lib = kernel_lib.load("spmm_rowmask", _SIGNATURES)
    dev = node_feats.device
    n, f = csr.num_nodes, node_feats.shape[1]
    # allocated first, so the poisoned-output checks find them in the block freed just before
    out = torch.empty(n, f, dtype=torch.float32, device=dev)
    den = torch.empty(n, heads, dtype=torch.float32, device=dev) if with_denom else None
    table, ld, bf16 = _gathered_table(csr, node_feats, stream_dtype, "K1")
    if heads > 1:
        table = _aligned16(table)  # the heads modes take aligned rows only
    wt = None if w is None else _edge_weights(w, dev)
    if wt is not None and heads > 1:
        wt = _aligned16(wt)  # a lane loads its heads' weights as one vector
    if n == 0 or f == 0:
        return out, den
    elem = 2 if bf16 else 4
    g, tile = k1_lanes(f, elem, ld % (16 // elem) == 0 and table.data_ptr() % 16 == 0)
    chunk = K1_CHUNK["heads" if heads > 1 else "one_head"]
    item_row, item_beg, split_rows = _work_items(csr, chunk)
    if split_rows.numel():
        out.index_fill_(0, split_rows, 0.0)
        if den is not None:
            den.index_fill_(0, split_rows, 0.0)
    rc = lib.stg_spmm_rowmask(
        csr.indptr.data_ptr(),
        csr.cols.data_ptr(),
        None if wt is None else wt.data_ptr(),
        table.data_ptr(),
        int(bf16),
        item_row.data_ptr(),
        item_beg.data_ptr(),
        item_row.numel(),
        out.data_ptr(),
        None if den is None else den.data_ptr(),
        f,
        ld,
        heads,
        chunk,
        g,
        tile,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 ({counter.__name__}) launch failed with cudaError {rc}")
    counter.launches += 1
    return out, den


def spmm_rowmask(
    csr: CSR,
    w: Optional[torch.Tensor],
    node_feats: torch.Tensor,
    heads: int = 1,
    with_denom: bool = False,
    stream_dtype=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``out[d, c] = sum_e w[e, c // F] * node_feats[src_e, c]``, f32, as
    ``(out, den)``.

    ``w`` is (capacity,) or (capacity, 1) in CSR order for one head,
    (capacity, heads) for several, or None for the unweighted path.
    ``node_feats`` is (num_cols, heads * F); several heads need
    ``128 % F == 0`` and ``(heads * F) % 128 == 0`` (``ValueError``
    otherwise, as in the JAX package). ``out`` is (num_nodes, heads * F).
    ``with_denom`` also returns ``den[d, h] = sum_e w[e, h]``
    (num_nodes, heads) f32, summed from the unrounded weights in the same
    pass; otherwise ``den`` is None. ``stream_dtype=torch.bfloat16`` streams
    the features as bf16 with f32 sums (the JAX package's rule for large
    graphs).
    """
    _check_k1(csr, w, node_feats, heads, with_denom)
    if node_feats.device.type == "cpu":
        res = spmm_rowmask_plain(csr, w, node_feats, stream_dtype, heads=heads, with_denom=with_denom)
        return res if with_denom else (res, None)
    return _launch_k1(spmm_rowmask, csr, w, node_feats, heads, with_denom, stream_dtype)


spmm_rowmask.launches = 0  # kernel launches since the count was last reset


def spmm_rowmask_traced(
    csr: CSR,
    w: Optional[torch.Tensor],
    table: torch.Tensor,
    heads: int = 1,
    with_denom: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K1's shard mode: ``spmm_rowmask`` over one shard's CSR, as ``(out,
    den)``, streaming the table's own dtype.

    ``csr`` is a shard CSR (``DistGraph.shard``): its columns index
    ``table``'s ``csr.num_cols`` rows (``[local | halo]``, the halo buffer,
    or the local rows) and ``out`` has its ``csr.num_nodes`` rows. The
    stream is bf16 when ``table`` is bf16 and f32 otherwise, as JAX's
    ``spmm_rowmask_traced`` streams the dtype of its pre-gathered rows. ``w``,
    ``heads`` and ``with_denom`` are as for ``spmm_rowmask``. A CSR with no
    edges gives zeros (the kernel writes every row). Launches count on
    ``spmm_rowmask_traced.launches``, not on ``spmm_rowmask``'s.
    """
    _check_k1(csr, w, table, heads, with_denom)
    stream = torch.bfloat16 if table.dtype == torch.bfloat16 else torch.float32
    if table.device.type == "cpu":
        res = spmm_rowmask_plain(csr, w, table, stream, heads=heads, with_denom=with_denom)
        return res if with_denom else (res, None)
    return _launch_k1(spmm_rowmask_traced, csr, w, table.to(stream), heads, with_denom, stream)


spmm_rowmask_traced.launches = 0  # kernel launches since the count was last reset


def spmm_rowmask_bwd_plain(
    csr_t: CSR,
    w_t: torch.Tensor,
    g: torch.Tensor,
    fs: torch.Tensor,
    stream_dtype=None,
    edge_block: Optional[int] = None,
    heads: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: ``dh`` by K1's plain version on ``csr_t``, and
    ``dw_t`` by gathering ``fs[rows_t]`` and ``g[cols_t]`` per edge.

    Rounds as the kernel rounds (bf16 stream: bf16 ``fs`` and ``g``, each
    elementwise product rounded to bf16) and sums each head's dot product
    in f64, rounded once to f32. Padding slots of ``dw_t`` are 0; it is
    (capacity,) for one head and (capacity, heads) for several.
    ``edge_block`` bounds the (edges, F) temporaries, as for
    ``spmm_rowmask_plain``.
    """
    dh = spmm_rowmask_plain(csr_t, w_t, g, stream_dtype, edge_block, heads=heads)
    f = g.shape[1] // heads
    e = int(csr_t.host_arrays()[0][-1])
    bf16 = _stream_is_bf16(g, stream_dtype)
    dt = torch.bfloat16 if bf16 else torch.float32
    dw = torch.zeros(csr_t.capacity, heads, dtype=torch.float32, device=g.device)
    block = max(e, 1) if edge_block is None else edge_block
    for e0 in range(0, e, block):
        e1 = min(e0 + block, e)
        a = fs[csr_t.rows[e0:e1].long()].to(dt).float()
        b = g[csr_t.cols[e0:e1].long()].to(dt).float()
        prod = a * b
        if bf16:
            prod = prod.to(torch.bfloat16).float()
        dw[e0:e1] = prod.double().reshape(e1 - e0, heads, f).sum(-1).float()
    return dh, (dw.reshape(-1) if heads == 1 else dw)


def spmm_rowmask_bwd(
    csr_t: CSR,
    w_t: torch.Tensor,
    g: torch.Tensor,
    fs: torch.Tensor,
    stream_dtype=None,
    heads: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dh, dw_t)`` of a weighted SpMM in one pass over ``csr_t``.

    Call it on the TRANSPOSE CSR with the weights ``w_t`` in transpose edge
    order, the output cotangent ``g`` ((csr_t.num_cols, heads * F): the
    forward's rows) and the forward's input features ``fs``
    ((csr_t.num_nodes, heads * F): the forward's table). ``dh`` is
    (csr_t.num_nodes, heads * F) f32; ``dw_t`` is
    in transpose edge order, 0 on padding slots: (capacity,) f32 for one
    head, (capacity, heads) for several (the tiling rule of
    ``spmm_rowmask``). ``stream_dtype`` as for ``spmm_rowmask`` (it decides
    from ``g``'s dtype when None).
    """
    n = csr_t.num_nodes
    if g.dim() != 2 or g.shape[0] != csr_t.num_cols or fs.shape != (n, g.shape[1]):
        raise ValueError(
            f"g must be (num_cols={csr_t.num_cols}, F) and fs (num_nodes={n}, F), "
            f"got {tuple(g.shape)} and {tuple(fs.shape)}"
        )
    _head_width(g.shape[1], heads, "spmm_rowmask_bwd")
    if w_t.numel() != csr_t.capacity * heads:
        raise ValueError(f"w_t must hold {heads} weight(s) per edge slot ({csr_t.capacity} slots)")
    if g.device.type == "cpu":
        return spmm_rowmask_bwd_plain(csr_t, w_t, g, fs, stream_dtype, heads=heads)

    lib = kernel_lib.load("spmm_sddmm_rowmask", _K2_SIGNATURES)
    dev = g.device
    if fs.device != dev:
        raise ValueError("fs must be on g's device")
    f = g.shape[1]
    # allocated first, so the poisoned-output checks find them in the blocks freed just before
    dh = torch.empty(n, f, dtype=torch.float32, device=dev)
    dw = torch.empty(csr_t.capacity, heads, dtype=torch.float32, device=dev)
    table, ld, bf16 = _gathered_table(csr_t, g, stream_dtype, "K2")
    wt = _edge_weights(w_t, dev)
    if heads > 1:  # the heads modes take aligned rows and load a lane's weights as one vector
        table, wt = _aligned16(table), _aligned16(wt)
    fs32 = fs.to(torch.float32).contiguous()  # rounded to the stream in the kernel
    dw[int(csr_t.host_arrays()[0][-1]):] = 0.0  # padding slots belong to no item
    if n == 0 or f == 0:
        dw.zero_()
    else:
        elem = 2 if bf16 else 4
        lanes, tile = k1_lanes(f, elem, ld % (16 // elem) == 0 and table.data_ptr() % 16 == 0)
        chunk = K2_CHUNK["heads" if heads > 1 else "one_head"]
        item_row, item_beg, split_rows = _work_items(csr_t, chunk)
        if split_rows.numel():
            dh.index_fill_(0, split_rows, 0.0)
        rc = lib.stg_spmm_sddmm_rowmask(
            csr_t.indptr.data_ptr(),
            csr_t.cols.data_ptr(),
            wt.data_ptr(),
            table.data_ptr(),
            int(bf16),
            fs32.data_ptr(),
            item_row.data_ptr(),
            item_beg.data_ptr(),
            item_row.numel(),
            dh.data_ptr(),
            dw.data_ptr(),
            f,
            ld,
            heads,
            chunk,
            lanes,
            tile,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if rc != 0:
            raise RuntimeError(f"K2 (spmm_rowmask_bwd) launch failed with cudaError {rc}")
        spmm_rowmask_bwd.launches += 1
    return dh, (dw.reshape(-1) if heads == 1 else dw)


spmm_rowmask_bwd.launches = 0  # kernel launches since the count was last reset
