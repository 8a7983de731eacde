"""STGraph-TPU's PyTorch/CUDA port: the vertex-centric GNN framework on an
NVIDIA H100.

A second package beside ``stgraph_tpu`` (the JAX reference, which it never
imports). It keeps the JAX package's module layout and names so each part
has a visible counterpart, uses PyTorch idiom inside, and replaces every
Pallas TPU kernel on its path with a kernel written by hand for Hopper
(``csrc/``), built at first use. Entry points take ``device=`` and run on
CUDA unless the caller asks for the CPU.

Ported, which is all of the JAX package: the graph core (CSR,
``StaticGraph``, the blocked layouts, the locality reorder) and the naive,
delta, lazy and PMA dynamic stores; the segment, message, attention and
dynamic SpMM ops with every Pallas kernel of the JAX package as a CUDA
kernel (K1-K10, K1's shard mode), and ``segment_sum_edges``; the vertex
compiler; ``GCNConv``, ``GATConv`` (flash, rowmask and blocked routes,
attention dropout), ``TGCN``, ``EvolveGCNO`` and ``EvolveGCNH``;
``Predictor``, checkpoints and the training helpers; the datasets (Cora,
Pubmed, OGB, England-COVID and the six static-temporal loaders); the
utilities (``DataTable``, ``DeviceInfo``, ``profiler``, the fetches with a
timeout, the built libraries' cache); the distribution layer
(``parallel``: partition, halo exchange, mesh, layers, launch, distributed
dynamic graphs ``DistDynGraph``, ``partition_dynamic``,
``shard_dyn_arrays``, ``dist_dyn_apply_delta``, ``dist_dyn_spmm``,
``dist_dyn_degree``, and 2-D window batches ``shard_window_batch``,
``dist_tgcn_batched_loss``); and the drivers
(``drivers.static_temporal_tgcn``, ``drivers.dynamic_temporal_tgcn``,
``drivers.evolvegcn``). The JAX names with no counterpart, each on
purpose, are listed in ``tests/test_torch_hygiene.py``.
"""

from stgraph_tpu_torch import compiler, convert, dataset, graph, nn, ops, parallel, serve, utils
from stgraph_tpu_torch.compiler.stgraph import STGraph
from stgraph_tpu_torch.graph import CSR, StaticGraph

__version__ = "0.1.0"  # the JAX package's

__all__ = [
    "CSR",
    "STGraph",
    "StaticGraph",
    "compiler",
    "convert",
    "dataset",
    "graph",
    "nn",
    "ops",
    "parallel",
    "serve",
    "utils",
]
