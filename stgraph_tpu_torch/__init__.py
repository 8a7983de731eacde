"""STGraph-TPU's PyTorch/CUDA port: the vertex-centric GNN framework on an
NVIDIA H100.

A second package beside ``stgraph_tpu`` (the JAX reference, which it never
imports). It keeps the JAX package's module layout and names so each part
has a visible counterpart, uses PyTorch idiom inside, and replaces every
Pallas TPU kernel on its path with a kernel written by hand for Hopper
(``csrc/``), built at first use. Entry points take ``device=`` and run on
CUDA unless the caller asks for the CPU.

Ported so far (the serving slice): the CSR and static graph, the segment
and message ops, the vertex compiler, ``GCNConv``, ``Predictor``, the OGB
loader, and K1 (row-wise SpMM) as a CUDA kernel.
"""

from stgraph_tpu_torch import compiler, convert, dataset, graph, nn, ops, serve, utils
from stgraph_tpu_torch.compiler.stgraph import STGraph
from stgraph_tpu_torch.graph import CSR, StaticGraph

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
    "serve",
    "utils",
]
