"""Graph storage layer: CSR core and the static graph class.

Counterpart of ``stgraph_tpu/graph/`` for the serving slice; the dynamic
stores (naive, delta, PMA, lazy) and the reorder pass are later slices.
"""

from stgraph_tpu_torch.graph.csr import CSR, build_csr, pad_edges, round_up
from stgraph_tpu_torch.graph.static_graph import StaticGraph

__all__ = ["CSR", "StaticGraph", "build_csr", "pad_edges", "round_up"]
