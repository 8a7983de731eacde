"""Message-passing primitives over CSR graphs: gather, SpMM, SDDMM.

Counterpart of ``stgraph_tpu/ops/message.py``: the functional target of the
compiler's lowering. Three execution paths share one semantics:

  * ``impl='torch'``  — plain torch gather + masked segment reduce. The
    port's oracle; on CUDA it runs only when the caller asks for it.
  * ``impl='dense'``  — the adjacency as a dense (N, N) matrix and one
    ``torch.matmul`` (the JAX package leaves this product to XLA too).
  * ``impl='kernel'`` — the hand-written SpMM kernel (``ops.spmm_cuda``), the
    counterpart of JAX's ``impl='pallas'``.

``impl='auto'`` picks dense when the adjacency fits a 64 MB budget; else
the kernel for a sum on CUDA tensors, and torch on CPU tensors. Max, min
and mean SpMM have a kernel in neither package and run the torch ops.

On CUDA tensors of a graph with at least ``_KERNEL_MIN_EDGES`` edge slots,
as on the JAX package's TPU: ``aggregate`` sends a narrow (K <= 16) sum or
mean to K3 and a narrow max to K4; ``spmm`` sends a multi-head weighted sum
((N, H, F) features, (capacity, H) weights) whose tiling the row-wise
kernel's multi-head mode would not take to the blocked kernel K10
(``ops.spmm_blocked``). Still waiting: wide sums for K1's no-gather mode
(``segment_sum_wide``), wide maxima for K5, and the other multi-head
tilings for K1's and K2's multi-head modes (those raise).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import segment as seg

__all__ = [
    "gather_src",
    "gather_dst",
    "edge_data_to_csr_order",
    "aggregate",
    "spmm",
    "sddmm",
    "csr_to_dense",
]

# Dense-path budget: adjacency bytes we are willing to spend (the JAX
# package's value: 64 MB of f32 covers N = 4096).
_DENSE_BUDGET_BYTES = 64 * 1024 * 1024

# Minimum edge capacity for the kernel routes of ``aggregate`` and the
# multi-head ``spmm`` (the JAX package's ``_PALLAS_MIN_EDGES``).
_KERNEL_MIN_EDGES = 50_000


def gather_src(csr: CSR, node_feat: torch.Tensor) -> torch.Tensor:
    """Per-edge source features ``node_feat[src]`` in CSR edge order.
    Padding edges read node ``num_nodes - 1`` and pass no gradient back,
    as XLA's gather does (``segment.gather_rows``)."""
    return seg.gather_rows(node_feat, csr.cols, csr.cols_clamped)


def gather_dst(csr: CSR, node_feat: torch.Tensor) -> torch.Tensor:
    """Per-edge destination features ``node_feat[dst]`` in CSR edge order."""
    return seg.gather_rows(node_feat, csr.rows, csr.rows_clamped)


def edge_data_to_csr_order(csr: CSR, edata: torch.Tensor) -> torch.Tensor:
    """Permute user-order edge data into CSR edge order via ``eids``."""
    return edata[csr.eids.clamp(max=edata.shape[0] - 1).long()]


def aggregate(
    csr: CSR,
    edge_vals: torch.Tensor,
    reduce: str = "sum",
    masked: bool = True,
) -> torch.Tensor:
    """Segment-reduce per-edge values into per-destination rows.

    On a CUDA tensor whose trailing width is at most ``MAX_NARROW_K`` (16),
    on a graph of at least ``_KERNEL_MIN_EDGES`` edge slots, a sum goes to
    the narrow segment-sum kernel K3, a mean to K3 divided by
    ``max(in-degree, 1)``, and a max to the narrow segment-max kernel K4
    (``ops.segment_kernels``), as the JAX package sends them to its Pallas
    kernels on the TPU (``stgraph_tpu/ops/message.py:94-112``; the port's
    CSR is always concrete). Every other reduction runs the torch segment
    ops: wide sums wait for K1's no-gather mode (``segment_sum_wide``), wide
    maxima for K5, and ``min`` has a kernel in neither package.
    """
    on_card = edge_vals.device.type != "cpu"
    if reduce in ("sum", "mean", "max") and on_card and csr.capacity >= _KERNEL_MIN_EDGES:
        from stgraph_tpu_torch.ops.segment_kernels import MAX_NARROW_K, SegmentMaxNarrow, SegmentSumNarrow

        trailing = tuple(edge_vals.shape[1:])
        k = int(np.prod(trailing)) if trailing else 1
        if k <= MAX_NARROW_K:
            vals = edge_vals.reshape(csr.capacity, k).float()
            if reduce == "max":
                out = SegmentMaxNarrow.apply(vals, csr)
            else:
                out = SegmentSumNarrow.apply(vals, csr)
                if reduce == "mean":
                    out = out / csr.degrees().clamp(min=1).to(out.dtype)[:, None]
            return out.reshape((csr.num_nodes,) + trailing).to(edge_vals.dtype)
    mask = csr.edge_mask if masked else None
    fn = {
        "sum": seg.segment_sum,
        "max": seg.segment_max,
        "min": seg.segment_min,
        "mean": seg.segment_mean,
    }[reduce]
    return fn(edge_vals, csr.rows, csr.num_nodes, edge_mask=mask)


def csr_to_dense(
    csr: CSR,
    edge_weight: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Materialize the (N, N) dense adjacency ``A[dst, src]``.

    ``A @ H`` equals sum-aggregation of in-neighbor features. Padding edges
    are masked out (JAX drops their out-of-range scatter).
    """
    n = csr.num_nodes
    mask = csr.edge_mask
    vals = (
        torch.ones(csr.capacity, dtype=dtype, device=csr.device)
        if edge_weight is None
        else edge_weight.reshape(-1).to(dtype)
    )
    flat = csr.rows_clamped.long() * n + csr.cols_clamped.long()
    dense = torch.zeros(n * n, dtype=dtype, device=csr.device)
    dense = dense.index_add(0, flat[mask], vals[mask])
    return dense.reshape(n, n)


def spmm(
    csr: CSR,
    node_feat: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    reduce: str = "sum",
    impl: str = "auto",
) -> torch.Tensor:
    """``out[dst] = reduce_{(src,dst) in E} edge_weight * node_feat[src]``.

    ``edge_weight`` is in CSR edge order, shape (capacity,) or
    (capacity, 1) (or (capacity, H) against (N, H, F) features). Per-head
    weights on a CUDA tensor go to the kernel route when ``impl`` asks for
    it, or when 'auto' or 'dense' meets a graph of at least
    ``_KERNEL_MIN_EDGES`` edge slots (the blocked kernel K10 over the CSR's
    blocked layouts, built once per CSR), as the JAX package sends them to
    its blocked Pallas kernel.
    """
    requested = impl
    impl = _resolve_impl(csr, node_feat, impl, reduce)
    if edge_weight is not None and not torch.is_tensor(edge_weight):
        edge_weight = torch.as_tensor(edge_weight, device=node_feat.device)
    if edge_weight is not None and edge_weight.dim() == 0:
        # Scalar weight: fold into the features, keep the fast paths.
        node_feat = node_feat * edge_weight
        edge_weight = None
    # The dense path folds one scalar weight per edge into the adjacency;
    # per-head weights take the kernel route on the card and the torch path
    # elsewhere.
    if impl in ("dense", "kernel") and not (edge_weight is None or edge_weight.numel() == csr.capacity):
        on_card = node_feat.device.type != "cpu"
        big = requested == "kernel" or csr.capacity >= _KERNEL_MIN_EDGES
        impl = "kernel" if on_card and big else "torch"
    if impl == "dense" and reduce == "sum":
        a = csr_to_dense(csr, edge_weight, dtype=node_feat.dtype)
        flat = node_feat.reshape(node_feat.shape[0], -1)
        out = torch.matmul(a.float(), flat.float())
        return out.to(node_feat.dtype).reshape(node_feat.shape)
    if impl == "kernel":
        from stgraph_tpu_torch.ops import spmm_cuda

        return spmm_cuda.spmm(csr, node_feat, edge_weight, reduce)
    if impl != "torch" and impl != "dense":
        raise ValueError(f"unknown spmm impl: {impl!r}")
    msg = gather_src(csr, node_feat)
    if edge_weight is not None:
        w = edge_weight
        if w.dim() < msg.dim():
            w = w.reshape(tuple(w.shape) + (1,) * (msg.dim() - w.dim()))
        msg = msg * w
    return aggregate(csr, msg, reduce=reduce)


def sddmm(
    csr: CSR,
    src_feat: torch.Tensor,
    dst_feat: torch.Tensor,
    op: str = "dot",
) -> torch.Tensor:
    """Sampled dense-dense products: per-edge ``op(src_feat[s], dst_feat[d])``
    in CSR edge order. ``'dot'`` contracts the last axis."""
    a = gather_src(csr, src_feat)
    b = gather_dst(csr, dst_feat)
    if op == "dot":
        return torch.sum(a * b, dim=-1)
    if op == "add":
        return a + b
    if op == "mul":
        return a * b
    raise ValueError(f"unknown sddmm op: {op}")


def _resolve_impl(csr: CSR, node_feat: torch.Tensor, impl: str, reduce: str) -> str:
    if impl != "auto":
        return impl
    n = csr.num_nodes
    if reduce == "sum" and n * n * node_feat.element_size() <= _DENSE_BUDGET_BYTES:
        return "dense"
    if reduce == "sum" and node_feat.device.type != "cpu":
        return "kernel"
    return "torch"
