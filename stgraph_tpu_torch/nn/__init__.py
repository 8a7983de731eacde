"""NN layers on the vertex-centric frontend (torch ``nn.Module``s).

Counterpart of ``stgraph_tpu/nn/``; GCN came with the serving slice and
TGCN with the training slice; GAT and EvolveGCN come with later slices.
"""

from stgraph_tpu_torch.nn.gcn_conv import GCNConv
from stgraph_tpu_torch.nn.tgcn import TGCN

__all__ = ["GCNConv", "TGCN"]
