"""Sparse message-passing ops: segment reductions, SpMM, SDDMM.

Counterpart of ``stgraph_tpu/ops/``: plain torch paths (the port's oracle),
the dense-adjacency path, and the hand-written CUDA kernels behind one
functional API. Kernels are built and loaded only when a CUDA tensor first
reaches them, never at import.
"""

from stgraph_tpu_torch.ops.message import (
    aggregate,
    csr_to_dense,
    edge_data_to_csr_order,
    gather_dst,
    gather_src,
    sddmm,
    spmm,
)
from stgraph_tpu_torch.ops.segment import (
    broadcast_to_edges,
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_sum,
)
from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_plain

__all__ = [
    "aggregate",
    "broadcast_to_edges",
    "csr_to_dense",
    "edge_data_to_csr_order",
    "gather_dst",
    "gather_src",
    "sddmm",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_sum",
    "spmm",
    "spmm_rowmask",
    "spmm_rowmask_plain",
]
