"""Static graph: a fixed-topology graph backed by padded CSR tensors.

Counterpart of ``stgraph_tpu/graph/static_graph.py`` (constructor
``StaticGraph(edge_list, edge_weights, num_nodes)``, accessors
``get_num_nodes/get_num_edges/get_ndata/set_ndata/in_degrees/out_degrees``).
The forward CSR (dst-major in-neighbors) and the backward CSR (its
transpose) are built on the host and placed on ``device``; their blocked
layouts (``blocked_fwd``, ``blocked_bwd``), which the blocked SpMM kernel K10
reads, are built on first use, once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from stgraph_tpu_torch.graph.blocked import BlockedCSR, blocked_layout
from stgraph_tpu_torch.graph.csr import CSR, build_csr
from stgraph_tpu_torch.graph.stgraph_base import STGraphBase
from stgraph_tpu_torch.utils.device import resolve_device


class StaticGraph(STGraphBase):
    """Fixed-topology graph with node/edge data dictionaries.

    ``edge_list`` is an (E, 2) array of (src, dst) pairs, or any sequence of
    pairs. An array is taken as it is: at ogbn scale a list of 10^8 pairs
    would cost minutes and tens of GB of Python objects.
    """

    def __init__(
        self,
        edge_list: Sequence,
        edge_weights: Optional[Sequence] = None,
        num_nodes: Optional[int] = None,
        pad_multiple: int = 8,
        device=None,
    ) -> None:
        super().__init__()
        self._device = resolve_device(device)
        if not isinstance(edge_list, np.ndarray):
            edge_list = np.asarray(list(edge_list), dtype=np.int64)
        edges = edge_list.reshape(-1, 2)
        if num_nodes is None:
            num_nodes = int(edges.max()) + 1 if len(edges) else 0
        self._num_nodes = int(num_nodes)
        self._num_edges = edges.shape[0]

        src, dst = edges[:, 0], edges[:, 1]
        # Forward CSR aggregates over in-neighbors: row = dst, col = src.
        self._forward_graph = build_csr(
            src, dst, self._num_nodes, pad_multiple=pad_multiple, device=self._device
        )
        # Backward CSR (row = src, col = dst); both builds label eids by user
        # edge order, so edge data is shared.
        self._backward_graph = build_csr(
            dst,
            src,
            self._num_nodes,
            capacity=self._forward_graph.capacity,
            device=self._device,
        )

        if edge_weights is not None:
            w = np.asarray(edge_weights, dtype=np.float32).reshape(-1)
            if w.shape[0] != self._num_edges:
                raise ValueError("edge_weights length must equal num_edges")
            self.set_edata("edge_weight", torch.from_numpy(w.reshape(-1, 1)).to(self._device))

    # -- reference API surface -------------------------------------------
    @property
    def fwd_csr(self) -> CSR:
        return self._forward_graph

    @property
    def bwd_csr(self) -> CSR:
        return self._backward_graph

    @property
    def blocked_fwd(self) -> BlockedCSR:
        """The forward CSR's blocked layout (built once, on the graph's device)."""
        return blocked_layout(self._forward_graph)

    @property
    def blocked_bwd(self) -> BlockedCSR:
        """The backward CSR's blocked layout (built once, on the graph's device)."""
        return blocked_layout(self._backward_graph)

    def get_num_nodes(self) -> int:
        return self._num_nodes

    def get_num_edges(self) -> int:
        return self._num_edges

    def graph_type(self) -> str:
        return "csr"

    def in_degrees(self) -> np.ndarray:
        return np.diff(self._forward_graph.host_arrays()[0]).astype(np.int32)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self._backward_graph.host_arrays()[0]).astype(np.int32)

    def weighted_in_degrees(self) -> np.ndarray:
        """Sum of in-edge weights per node (reference ``csr.cu:48-50``)."""
        w = self.get_edata("edge_weight")
        if w is None:
            return self.in_degrees()
        _, rows, _, eids = self._forward_graph.host_arrays()
        e = self._num_edges
        w_sorted = w.detach().cpu().numpy().reshape(-1)[eids[:e]]
        seg = np.zeros(self._num_nodes, dtype=np.float64)
        np.add.at(seg, rows[:e], w_sorted)
        return seg
