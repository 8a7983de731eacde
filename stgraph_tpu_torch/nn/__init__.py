"""NN layers on the vertex-centric frontend (torch ``nn.Module``s).

Counterpart of ``stgraph_tpu/nn/``: ``GCNConv``, ``GATConv``, ``TGCN`` and
EvolveGCN's two variants, ``EvolveGCNO`` and ``EvolveGCNH``.
"""

from stgraph_tpu_torch.nn.evolvegcn import EvolveGCNH, EvolveGCNO
from stgraph_tpu_torch.nn.gat_conv import GATConv
from stgraph_tpu_torch.nn.gcn_conv import GCNConv
from stgraph_tpu_torch.nn.tgcn import TGCN

__all__ = ["EvolveGCNH", "EvolveGCNO", "GATConv", "GCNConv", "TGCN"]
