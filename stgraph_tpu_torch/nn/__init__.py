"""NN layers on the vertex-centric frontend (torch ``nn.Module``s).

Counterpart of ``stgraph_tpu/nn/``; GCN came with the serving slice, TGCN
with the training slice and GAT with the third; EvolveGCN comes later.
"""

from stgraph_tpu_torch.nn.gat_conv import GATConv
from stgraph_tpu_torch.nn.gcn_conv import GCNConv
from stgraph_tpu_torch.nn.tgcn import TGCN

__all__ = ["GATConv", "GCNConv", "TGCN"]
