"""STGraph-TPU's PyTorch/CUDA port: the vertex-centric GNN framework on an
NVIDIA H100.

A second package beside ``stgraph_tpu`` (the JAX reference, which it never
imports). It keeps the JAX package's module layout and names so each part
has a visible counterpart, uses PyTorch idiom inside, and replaces every
Pallas TPU kernel on its path with a kernel written by hand for Hopper
(``csrc/``), built at first use. Entry points take ``device=`` and run on
CUDA unless the caller asks for the CPU.

Ported so far: the serving slice (the CSR and static graph, the segment
and message ops, the vertex compiler, ``GCNConv``, ``Predictor``, the OGB
loader, and K1, the row-wise SpMM, as a CUDA kernel) and the training
slice (the SpMM backward through K1 on the transpose CSR and K2, the fused
SpMM backward, as a CUDA kernel; ``TGCN``; checkpoints and
``Predictor.from_checkpoint``; the training helpers; Cora) and GAT
(``GATConv`` and flash-GAT's attention, with K4, the narrow segment max,
K8, the fused attention forward, and K9, its backward, as CUDA kernels;
Pubmed).
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
