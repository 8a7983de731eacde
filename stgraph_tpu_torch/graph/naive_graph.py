"""Naive dynamic graph: one prebuilt CSR snapshot per timestamp.

Counterpart of ``stgraph_tpu/graph/naive_graph.py``: every snapshot's
forward CSR and its transpose are built on the host at one padded capacity
and placed on ``device`` (default ``cuda``). It is the snapshot path that
the lazy store is held against.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR, build_csr, round_up
from stgraph_tpu_torch.graph.dynamic_graph import DynamicGraph
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["NaiveGraph"]


class NaiveGraph(DynamicGraph):
    """Prebuilds every snapshot's forward and transpose CSR."""

    def __init__(
        self,
        edge_lists: Sequence[Sequence[Tuple[int, int]]],
        edge_weight_lists: Optional[Sequence[Sequence[float]]] = None,
        pad_multiple: int = 8,
        device=None,
    ) -> None:
        super().__init__(edge_lists)
        dev = resolve_device(device)
        capacity = round_up(max(self.max_num_edges, 1), pad_multiple)
        self._capacity = capacity
        self._fwd: List[CSR] = []
        self._weights: Optional[List[torch.Tensor]] = [] if edge_weight_lists is not None else None
        for t, edges in enumerate(self._edge_lists):
            self._fwd.append(build_csr(edges[:, 0], edges[:, 1], self._num_nodes, capacity=capacity, device=dev))
            if self._weights is not None:
                # USER edge order, zero-padded: the layers permute it into CSR
                # order through the eids (the e_feats contract)
                w = np.asarray(edge_weight_lists[t], dtype=np.float32).reshape(-1)
                wp = np.zeros(capacity, dtype=np.float32)
                wp[: len(w)] = w
                self._weights.append(torch.from_numpy(wp.reshape(-1, 1)).to(dev))

    def get_graph(self, timestamp: int) -> CSR:
        return self._fwd[timestamp]

    def get_backward_graph(self, timestamp: int) -> CSR:
        return self._fwd[timestamp].transpose()

    def get_edge_weights(self, timestamp: int) -> Optional[torch.Tensor]:
        """(capacity, 1) edge weights at ``timestamp`` in USER edge order."""
        if self._weights is None:
            return None
        return self._weights[timestamp]

    def graph_type(self) -> str:
        return "csr"
