"""Distribution layer: edge partitioning and halo exchange over
``torch.distributed``.

Counterpart of ``stgraph_tpu/parallel``: the host partitioner in
``partition.py``, the halo-exchange SpMM and GAT attention in ``halo.py``,
the mesh in ``mesh.py``, process-group start-up in ``launch.py``, the
layers in ``layers.py``, distributed dynamic graphs (shard-local delta
replay, the all-gathered row-id SpMM and degree) in ``dyn.py`` and 2-D
window batches of TGCN in ``batch.py``.
"""

from stgraph_tpu_torch.parallel import launch
from stgraph_tpu_torch.parallel.batch import dist_tgcn_batched_loss, shard_window_batch
from stgraph_tpu_torch.parallel.dyn import (
    DistDynGraph,
    dist_dyn_apply_delta,
    dist_dyn_degree,
    dist_dyn_spmm,
    partition_dynamic,
    shard_dyn_arrays,
)
from stgraph_tpu_torch.parallel.halo import (
    dist_gat_attention,
    dist_spmm,
    replicate,
    shard_edge_array,
    shard_node_array,
)
from stgraph_tpu_torch.parallel.layers import (
    dist_gat_conv,
    dist_gat_params,
    dist_gcn_conv,
    dist_gcn_params,
    dist_tgcn_cell,
    dist_tgcn_params,
    reduce_replicated_grads,
)
from stgraph_tpu_torch.parallel.mesh import make_mesh
from stgraph_tpu_torch.parallel.partition import DistGraph, partition_edges

__all__ = [
    "DistDynGraph",
    "DistGraph",
    "dist_dyn_apply_delta",
    "dist_dyn_degree",
    "dist_dyn_spmm",
    "dist_gat_attention",
    "dist_gat_conv",
    "dist_gat_params",
    "dist_gcn_conv",
    "dist_gcn_params",
    "dist_spmm",
    "dist_tgcn_batched_loss",
    "dist_tgcn_cell",
    "dist_tgcn_params",
    "launch",
    "make_mesh",
    "partition_dynamic",
    "partition_edges",
    "reduce_replicated_grads",
    "replicate",
    "shard_dyn_arrays",
    "shard_edge_array",
    "shard_node_array",
    "shard_window_batch",
]
