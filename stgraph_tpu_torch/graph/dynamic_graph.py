"""Dynamic (discrete-time) graphs: per-timestamp topology as add/delete deltas.

A copy of ``stgraph_tpu/graph/dynamic_graph.py`` (host numpy; the port
imports nothing of the JAX package). ``preprocess_deltas`` turns
per-timestamp edge lists into per-timestamp ``{add, delete}`` deltas,
packing each edge as the int64 key ``dst << 32 | src`` so that a step's diff
is two sorted set differences; ``DynamicGraph`` is the base class of
``NaiveGraph`` (one CSR per snapshot) and ``DeltaGraph`` (one edge store
replayed by deltas).
"""

from __future__ import annotations

from abc import abstractmethod
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from stgraph_tpu_torch.graph.stgraph_base import STGraphBase

__all__ = ["DynamicGraph", "preprocess_deltas"]


def preprocess_deltas(
    edge_lists: Sequence[Sequence[Tuple[int, int]]],
    edge_weight_lists: Optional[Sequence[Sequence[float]]] = None,
) -> List[Dict[str, np.ndarray]]:
    """Per-timestamp edge lists as per-timestamp add/delete deltas.

    ``delta[t]['add']`` holds the (src, dst) edges present at ``t`` but not
    at ``t-1``, ``delta[t]['delete']`` the reverse; ``delta[0]`` adds the
    whole initial edge set. With ``edge_weight_lists``, an edge whose weight
    changes between timestamps appears in both lists (delete of the old, add
    of the new), and ``delta[t]['add_w']`` carries the added edges' weights.
    """
    weighted = edge_weight_lists is not None
    deltas: List[Dict[str, np.ndarray]] = []
    prev = np.empty(0, dtype=np.int64)
    prev_w = np.empty(0, dtype=np.float32)
    for t, edges in enumerate(edge_lists):
        e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        raw_keys = (e[:, 1] << 32) | e[:, 0]  # (dst, src) packing
        keys, first = np.unique(raw_keys, return_index=True)
        if not weighted:
            add = np.setdiff1d(keys, prev, assume_unique=True)
            delete = np.setdiff1d(prev, keys, assume_unique=True)
            deltas.append({"add": _unpack(add), "delete": _unpack(delete)})
        else:
            w = np.asarray(edge_weight_lists[t], np.float32).reshape(-1)[first]
            # keys and prev are sorted and unique: align them with
            # searchsorted and flag weight changes on the intersection as
            # delete + add pairs
            idx = np.searchsorted(prev, keys)
            idxc = np.minimum(idx, max(len(prev) - 1, 0))
            in_prev = (len(prev) > 0) & (idx < len(prev))
            in_prev = in_prev & (prev[idxc] == keys) if len(prev) else np.zeros(len(keys), bool)
            changed = in_prev & (prev_w[idxc] != w) if len(prev) else np.zeros(len(keys), bool)
            add_mask = ~in_prev | changed
            jdx = np.searchsorted(keys, prev)
            jdxc = np.minimum(jdx, max(len(keys) - 1, 0))
            in_cur = (len(keys) > 0) & (jdx < len(keys))
            in_cur = in_cur & (keys[jdxc] == prev) if len(keys) else np.zeros(len(prev), bool)
            changed2 = in_cur & (w[jdxc] != prev_w) if len(keys) else np.zeros(len(prev), bool)
            del_mask = ~in_cur | changed2
            deltas.append(
                {
                    "add": _unpack(keys[add_mask]),
                    "add_w": w[add_mask],
                    "delete": _unpack(prev[del_mask]),
                }
            )
            prev_w = w
        prev = keys
    return deltas


def _unpack(keys: np.ndarray) -> np.ndarray:
    """int64 (dst<<32|src) keys → (k, 2) int32 (src, dst) rows."""
    out = np.empty((len(keys), 2), dtype=np.int32)
    out[:, 0] = keys & 0xFFFFFFFF
    out[:, 1] = keys >> 32
    return out


class DynamicGraph(STGraphBase):
    """Base class for discrete-time dynamic graphs: ``get_graph(t)`` and
    ``get_backward_graph(t)`` return the snapshot's CSR and its transpose,
    both immutable."""

    def __init__(
        self,
        edge_lists: Sequence[Sequence[Tuple[int, int]]],
        edge_weight_lists: Optional[Sequence[Sequence[float]]] = None,
    ) -> None:
        super().__init__()
        self._edge_lists = [np.asarray(e, dtype=np.int64).reshape(-1, 2) for e in edge_lists]
        self._num_timestamps = len(self._edge_lists)
        nodes = 0
        for e in self._edge_lists:
            if len(e):
                nodes = max(nodes, int(e.max()) + 1)
        self._num_nodes = nodes
        self._deltas = preprocess_deltas(edge_lists, edge_weight_lists)
        self.max_num_edges = max((len(e) for e in self._edge_lists), default=0)
        # the reference's update-time counters
        self._update_time = 0.0
        self._move_to_device_time = 0.0

    @property
    def num_timestamps(self) -> int:
        return self._num_timestamps

    def get_num_nodes(self) -> int:
        return self._num_nodes

    def get_num_edges(self) -> int:
        return self.max_num_edges

    def get_fwd_graph_time(self) -> float:
        return self._update_time

    def get_bwd_graph_time(self) -> float:
        # immutable snapshots: backward needs no structure rebuild
        return 0.0

    def get_move_to_gpu_time(self) -> float:
        return self._move_to_device_time

    @abstractmethod
    def get_graph(self, timestamp: int):
        """Forward CSR snapshot at ``timestamp``."""

    @abstractmethod
    def get_backward_graph(self, timestamp: int):
        """Transpose CSR snapshot at ``timestamp``."""
