"""Sparse message-passing ops: segment reductions, SpMM, SDDMM.

Counterpart of ``stgraph_tpu/ops/``: plain torch paths (the port's oracle),
the dense-adjacency path, GAT's attention (``attention``, ``flash_gat``),
and the hand-written CUDA kernels behind one functional API. Kernels are
built and loaded only when a CUDA tensor first reaches them, never at
import.
"""

from stgraph_tpu_torch.ops.attention import (
    dense_gat_attention,
    flash_path_available,
    sparse_gat_attention,
)
from stgraph_tpu_torch.ops.flash_gat import (
    flash_gat_attention,
    flash_gat_bwd,
    flash_gat_bwd_plain,
    flash_gat_fwd,
    flash_gat_fwd_plain,
    flash_supported,
)
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
from stgraph_tpu_torch.ops.segment_kernels import (
    SegmentMaxNarrow,
    segment_max_narrow,
    segment_max_narrow_plain,
)
from stgraph_tpu_torch.ops.spmm_kernels import (
    spmm_rowmask,
    spmm_rowmask_bwd,
    spmm_rowmask_bwd_plain,
    spmm_rowmask_plain,
)

__all__ = [
    "SegmentMaxNarrow",
    "aggregate",
    "broadcast_to_edges",
    "csr_to_dense",
    "dense_gat_attention",
    "edge_data_to_csr_order",
    "flash_gat_attention",
    "flash_gat_bwd",
    "flash_gat_bwd_plain",
    "flash_gat_fwd",
    "flash_gat_fwd_plain",
    "flash_path_available",
    "flash_supported",
    "gather_dst",
    "gather_src",
    "sddmm",
    "segment_max",
    "segment_max_narrow",
    "segment_max_narrow_plain",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_sum",
    "sparse_gat_attention",
    "spmm",
    "spmm_rowmask",
    "spmm_rowmask_bwd",
    "spmm_rowmask_bwd_plain",
    "spmm_rowmask_plain",
]
