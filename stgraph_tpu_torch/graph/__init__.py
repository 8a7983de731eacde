"""Graph storage layer: CSR core and the static graph class.

Counterpart of ``stgraph_tpu/graph/``: the CSR core and its blocked layout,
the static graph, and the dynamic graphs (naive snapshots, the delta store,
the lazy store); the PMA store and the reorder pass are later slices.
"""

from stgraph_tpu_torch.graph.blocked import BlockedCSR, blocked_layout, build_blocked
from stgraph_tpu_torch.graph.csr import CSR, build_csr, pad_edges, round_up
from stgraph_tpu_torch.graph.delta_graph import DeltaGraph, EdgeStore, apply_delta, edge_store_to_csr
from stgraph_tpu_torch.graph.dynamic_graph import DynamicGraph, preprocess_deltas
from stgraph_tpu_torch.graph.lazy_store import LazyStore, apply_delta_lazy, compact, lazy_from_edges
from stgraph_tpu_torch.graph.naive_graph import NaiveGraph
from stgraph_tpu_torch.graph.static_graph import StaticGraph

__all__ = [
    "BlockedCSR",
    "CSR",
    "DeltaGraph",
    "DynamicGraph",
    "EdgeStore",
    "LazyStore",
    "NaiveGraph",
    "StaticGraph",
    "apply_delta",
    "apply_delta_lazy",
    "blocked_layout",
    "build_blocked",
    "build_csr",
    "compact",
    "edge_store_to_csr",
    "lazy_from_edges",
    "pad_edges",
    "preprocess_deltas",
    "round_up",
]
