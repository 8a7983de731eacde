"""NN layers on the vertex-centric frontend (torch ``nn.Module``s).

Counterpart of ``stgraph_tpu/nn/``; GCN is ported with the serving slice,
TGCN, GAT and EvolveGCN come with later slices.
"""

from stgraph_tpu_torch.nn.gcn_conv import GCNConv

__all__ = ["GCNConv"]
