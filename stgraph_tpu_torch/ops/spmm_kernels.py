"""K1 and K2: the row-wise SpMM kernel and its fused backward, each with its
wrapper and its plain PyTorch version.

Replaces ``stgraph_tpu/ops/segment_pallas.py``'s ``spmm_rowmask``
(``:913-1133``) and its Pallas kernel ``_spmm_rowmask_kernel`` (``:761``)
for one head:

    out[d, :] = sum_{e in row d} w[e] * node_feats[cols[e], :]     (f32)

The CUDA kernel lives in ``csrc/spmm_rowmask.cu``. On this card it is bound
by memory: two operations per gathered element, and the gathered rows are
spread over a table far larger than L2. Its bound is the compulsory bytes
(``indptr``, ``cols``, ``w``, the input table read once, the output written
once) over the card's memory rate; at ogbn-products size (E = 123.7M,
F = 128) that is about 1 ms on an H100 SXM, while the gathered traffic is
about 25 times more. The design (a warp per row, the gather inside the
kernel, a bf16 table made once, hub rows split across warps) is described
in the source.

K2 (``spmm_rowmask_bwd``, ``csrc/spmm_sddmm_rowmask.cu``) replaces
``segment_pallas.spmm_rowmask_bwd`` (``:1434-1618``) and its Pallas kernel
``_spmm_sddmm_rowmask_kernel`` (``:1248``) for one head. On the transpose
CSR, with the weights in transpose edge order, one pass gives

    dh[s, :] = sum_{e in row s} w_t[e] * g[cols_t[e], :]            (f32)
    dw_t[e]  = < fs[s, :], g[cols_t[e], :] >     (f32, 0 on padding slots)

It shares K1's work items (on the transpose ``indptr``) and its bound is
the same kind: memory, about 1.6 ms at ogbn-products size and F = 128.

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
    "ROW_CHUNK",
    "k1_work_items",
    "spmm_rowmask",
    "spmm_rowmask_bwd",
    "spmm_rowmask_bwd_plain",
    "spmm_rowmask_plain",
]

# Edges one warp takes from a row; longer rows are split into several work
# items whose partial sums meet by atomicAdd.
ROW_CHUNK = 1024

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "stg_spmm_rowmask": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP, _I, _I, _I, _VP],
}
_K2_SIGNATURES = {
    "stg_spmm_sddmm_rowmask": [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _VP],
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
) -> torch.Tensor:
    """K1's plain version: gather, product, masked ``index_add_``; f32 out.

    Only the real edges (positions below ``indptr[n]``) are summed. The
    products are rounded as the kernel rounds them: with a bf16 stream the
    gathered features and the weights are bf16 and their product is rounded
    to bf16. The sum is taken in f64 and rounded once to f32, so the plain
    version is the reference that the kernel's (and the TPU kernel's) f32
    sums approximate, whatever their order. Differentiable by autograd.

    ``edge_block`` bounds the (edges, F) temporaries: rows are taken in
    groups of about that many edges (at ogbn-products size one group of
    all edges would need some 63 GB). The result does not depend on it.
    """
    n, f = node_feats.shape
    indptr = csr.host_arrays()[0]
    e = int(indptr[-1])
    bf16 = _stream_is_bf16(node_feats, stream_dtype)
    block = max(e, 1) if edge_block is None else edge_block
    firsts = np.searchsorted(indptr, np.arange(0, e, block), side="right") - 1
    starts = np.unique(np.concatenate([[0], firsts]))
    bounds = list(starts[starts < n]) + [n]
    parts = []
    for r0, r1 in zip(bounds[:-1], bounds[1:]):
        e0, e1 = int(indptr[r0]), int(indptr[r1])
        x = node_feats[csr.cols[e0:e1].long()].to(torch.bfloat16 if bf16 else torch.float32)
        if w is None:
            msg = x.float()
        else:
            wt = w.reshape(-1)[e0:e1].to(torch.float32)[:, None]
            if bf16:
                msg = (x.float() * wt.to(torch.bfloat16).float()).to(torch.bfloat16).float()
            else:
                msg = x * wt
        out = torch.zeros(r1 - r0, f, dtype=torch.float64, device=node_feats.device)
        parts.append(out.index_add(0, csr.rows[e0:e1].long() - r0, msg.double()).float())
    if not parts:
        return torch.zeros(n, f, dtype=torch.float32, device=node_feats.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _work_items(csr: CSR):
    def make():
        item_row, item_beg, split_rows = k1_work_items(csr.host_arrays()[0])
        dev = csr.device
        return (
            torch.from_numpy(item_row).to(dev),
            torch.from_numpy(item_beg).to(dev),
            torch.from_numpy(split_rows).to(dev),
        )

    return csr.cached(f"k1_items_{ROW_CHUNK}", make)


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
        table = F.pad(table, (0, ld - f)) if ld != f else table.contiguous()
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


def spmm_rowmask(
    csr: CSR,
    w: Optional[torch.Tensor],
    node_feats: torch.Tensor,
    heads: int = 1,
    with_denom: bool = False,
    stream_dtype=None,
) -> Tuple[torch.Tensor, None]:
    """``out[d] = sum_e w[e] * node_feats[src_e]``, f32, as ``(out, None)``.

    ``w`` is (capacity,) or (capacity, 1) in CSR order, or None for the
    unweighted path. ``stream_dtype=torch.bfloat16`` streams the features
    as bf16 with f32 sums (the JAX package's rule for large graphs).
    ``heads > 1`` and ``with_denom`` (the composed GAT route's modes) are
    not ported yet.
    """
    if heads != 1 or with_denom:
        raise NotImplementedError(
            "multi-head K1 and its denominator come with the composed GAT route (ROADMAP.md)"
        )
    if node_feats.dim() != 2 or node_feats.shape[0] != csr.num_nodes:
        raise ValueError(
            f"node_feats must be (num_nodes={csr.num_nodes}, F), got {tuple(node_feats.shape)}"
        )
    if w is not None and w.numel() != csr.capacity:
        raise ValueError(f"w must hold one weight per edge slot ({csr.capacity})")
    if node_feats.device.type == "cpu":
        return spmm_rowmask_plain(csr, w, node_feats, stream_dtype), None

    lib = kernel_lib.load("spmm_rowmask", _SIGNATURES)
    dev = node_feats.device
    table, ld, bf16 = _gathered_table(csr, node_feats, stream_dtype, "K1")
    wt = None if w is None else _edge_weights(w, dev)
    n, f = node_feats.shape
    out = torch.empty(n, f, dtype=torch.float32, device=dev)
    if n == 0 or f == 0:
        return out, None
    item_row, item_beg, split_rows = _work_items(csr)
    if split_rows.numel():
        out.index_fill_(0, split_rows, 0.0)
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
        f,
        ld,
        ROW_CHUNK,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K1 (spmm_rowmask) launch failed with cudaError {rc}")
    spmm_rowmask.launches += 1
    return out, None


spmm_rowmask.launches = 0  # kernel launches since the count was last reset


def spmm_rowmask_bwd_plain(
    csr_t: CSR,
    w_t: torch.Tensor,
    g: torch.Tensor,
    fs: torch.Tensor,
    stream_dtype=None,
    edge_block: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: ``dh`` by K1's plain version on ``csr_t``, and
    ``dw_t`` by gathering ``fs[rows_t]`` and ``g[cols_t]`` per edge.

    Rounds as the kernel rounds (bf16 stream: bf16 ``fs`` and ``g``, each
    elementwise product rounded to bf16) and sums each dot product in f64,
    rounded once to f32. Padding slots of ``dw_t`` are 0. ``edge_block``
    bounds the (edges, F) temporaries, as for ``spmm_rowmask_plain``.
    """
    dh = spmm_rowmask_plain(csr_t, w_t, g, stream_dtype, edge_block)
    e = int(csr_t.host_arrays()[0][-1])
    bf16 = _stream_is_bf16(g, stream_dtype)
    dt = torch.bfloat16 if bf16 else torch.float32
    dw = torch.zeros(csr_t.capacity, dtype=torch.float32, device=g.device)
    block = max(e, 1) if edge_block is None else edge_block
    for e0 in range(0, e, block):
        e1 = min(e0 + block, e)
        a = fs[csr_t.rows[e0:e1].long()].to(dt).float()
        b = g[csr_t.cols[e0:e1].long()].to(dt).float()
        prod = a * b
        if bf16:
            prod = prod.to(torch.bfloat16).float()
        dw[e0:e1] = prod.double().sum(-1).float()
    return dh, dw


def spmm_rowmask_bwd(
    csr_t: CSR,
    w_t: torch.Tensor,
    g: torch.Tensor,
    fs: torch.Tensor,
    stream_dtype=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: ``(dh, dw_t)`` of a weighted SpMM in one pass over ``csr_t``.

    Call it on the TRANSPOSE CSR with the weights ``w_t`` in transpose edge
    order, the output cotangent ``g`` and the forward's input features
    ``fs`` (both (N, F)). ``dh`` is (N, F) f32; ``dw_t`` is (capacity,) f32
    in transpose edge order, 0 on padding slots. ``stream_dtype`` as for
    ``spmm_rowmask`` (it decides from ``g``'s dtype when None).
    """
    n = csr_t.num_nodes
    if g.dim() != 2 or g.shape[0] != n or fs.shape != g.shape:
        raise ValueError(
            f"g and fs must both be (num_nodes={n}, F), got {tuple(g.shape)} and {tuple(fs.shape)}"
        )
    if w_t.numel() != csr_t.capacity:
        raise ValueError(f"w_t must hold one weight per edge slot ({csr_t.capacity})")
    if g.device.type == "cpu":
        return spmm_rowmask_bwd_plain(csr_t, w_t, g, fs, stream_dtype)

    lib = kernel_lib.load("spmm_sddmm_rowmask", _K2_SIGNATURES)
    dev = g.device
    table, ld, bf16 = _gathered_table(csr_t, g, stream_dtype, "K2")
    if fs.device != dev:
        raise ValueError("fs must be on g's device")
    fs32 = fs.to(torch.float32).contiguous()  # rounded to the stream in the kernel
    wt = _edge_weights(w_t, dev)
    f = g.shape[1]
    dh = torch.empty(n, f, dtype=torch.float32, device=dev)
    dw = torch.empty(csr_t.capacity, dtype=torch.float32, device=dev)
    dw[int(csr_t.host_arrays()[0][-1]):] = 0.0  # padding slots belong to no item
    if n == 0 or f == 0:
        return dh, dw.zero_()
    item_row, item_beg, split_rows = _work_items(csr_t)
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
        ROW_CHUNK,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K2 (spmm_rowmask_bwd) launch failed with cudaError {rc}")
    spmm_rowmask_bwd.launches += 1
    return dh, dw


spmm_rowmask_bwd.launches = 0  # kernel launches since the count was last reset
