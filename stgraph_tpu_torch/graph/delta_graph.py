"""DeltaGraph: a sorted dynamic edge store with batch add/delete.

Counterpart of ``stgraph_tpu/graph/delta_graph.py``:

  * ``EdgeStore`` is (rows, cols, weights) of static capacity, sorted by
    (row, col), padding at the end (sentinel row == n); torch tensors on a
    device, or numpy arrays for the host snapshots;
  * ``apply_delta`` merges the sorted store with a sorted delta batch on the
    device: a sort over the delta only, merge positions by bisection, a
    shifted compare that cancels edge/tombstone pairs and a rank-select
    compaction, with no capacity-wide sort. Where JAX bisects (row, col)
    pairs by hand for lack of int64, the port packs each pair into one int64
    key and calls ``torch.searchsorted``; the positions are the same;
  * ``DeltaGraph`` replays the staged deltas with ``apply_delta`` on CPU
    tensors to make its host snapshots (where JAX keeps a numpy copy of the
    algorithm, ``_apply_delta_np``), and stages the padded deltas on the
    device for in-loop replay (``staged_deltas``, ``snapshot_store``), which
    the lazy-store training loop seeds from.

JAX's ``stacked()`` (snapshots as one pytree with a time axis, for
``lax.scan``) has no counterpart: the port loops over timesteps in Python.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR, round_up
from stgraph_tpu_torch.graph.dynamic_graph import DynamicGraph
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["DeltaGraph", "EdgeStore", "apply_delta", "edge_store_to_csr", "pack_keys"]

Array = Union[torch.Tensor, np.ndarray]


class EdgeStore(NamedTuple):
    """Sorted, padded edge store; ``rows[i] == num_nodes`` marks padding.

    ``weights`` is None for an unweighted graph, else (capacity,) f32 in
    store order, which is CSR edge order.
    """

    rows: Array  # (capacity,) int32, sorted by (row, col)
    cols: Array  # (capacity,) int32
    num_edges: Array  # () live edges
    num_nodes: int
    weights: Optional[Array] = None  # (capacity,) f32 or None


def pack_keys(rows: torch.Tensor, cols: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """(row, col) pairs, each id in ``[0, num_nodes]``, as int64 keys that
    sort as the pairs do lexicographically."""
    return rows.long() * (num_nodes + 1) + cols.long()


def _searchsorted_rc(ar, ac, qr, qc, num_nodes: int) -> torch.Tensor:
    """Right-bisect positions (int64) of the (qr, qc) keys in the
    (ar, ac)-sorted store: the count of store keys <= each query."""
    return torch.searchsorted(pack_keys(ar, ac, num_nodes), pack_keys(qr, qc, num_nodes), right=True)


def apply_delta(
    store: EdgeStore,
    add_rows: torch.Tensor,
    add_cols: torch.Tensor,
    del_rows: torch.Tensor,
    del_cols: torch.Tensor,
    add_weights: Optional[torch.Tensor] = None,
) -> EdgeStore:
    """Apply a batch of edge additions and deletions on the store's device.

    The batches are padded with the sentinel ``num_nodes``. Deletions must
    name existing edges; an addition must be new or paired with a same-key
    deletion in the same batch (a weight update). The result is a new store;
    the input is not modified.
    """
    n = store.num_nodes
    dev = store.rows.device
    cap = store.rows.shape[0]
    dd, da = del_rows.shape[0], add_rows.shape[0]
    d = dd + da
    weighted = store.weights is not None

    # Deletions first (kind 0), so that a same-key (store, del, add) triple
    # keeps that order: the tombstone cancels the store entry and the re-add
    # survives (weight updates).
    drows = torch.cat([del_rows, add_rows]).to(device=dev, dtype=torch.int32)
    dcols = torch.cat([del_cols, add_cols]).to(device=dev, dtype=torch.int32)
    dkind = torch.cat([torch.zeros(dd, dtype=torch.int64, device=dev), torch.ones(da, dtype=torch.int64, device=dev)])
    o = torch.sort(pack_keys(drows, dcols, n) * 2 + dkind, stable=True).indices
    drows, dcols, dkind = drows[o], dcols[o], dkind[o]
    if weighted:
        aw = (torch.ones(da, device=dev) if add_weights is None
              else add_weights.reshape(-1).to(device=dev, dtype=torch.float32))
        dw = torch.cat([torch.zeros(dd, device=dev), aw])[o]

    # Merge positions: store entries precede equal-key delta entries, so
    # q = p + j is the output slot of delta entry j, strictly increasing.
    p = _searchsorted_rc(store.rows, store.cols, drows, dcols, n)
    q = p + torch.arange(d, device=dev)
    big = cap + d
    i = torch.arange(big, device=dev)
    # t[i] = |{q < i}|: delta entries placed before slot i
    ind = torch.zeros(big + 1, dtype=torch.int64, device=dev)
    ind.index_add_(0, torch.clamp(q + 1, max=big), torch.ones_like(q))
    t = torch.cumsum(ind, 0)[:big]
    tc = torch.clamp(t, max=d - 1)
    is_delta = q[tc] == i
    sidx = torch.clamp(i - t, 0, cap - 1)
    m_rows = torch.where(is_delta, drows[tc], store.rows[sidx])
    m_cols = torch.where(is_delta, dcols[tc], store.cols[sidx])
    if weighted:
        m_w = torch.where(is_delta, dw[tc], store.weights[sidx])

    # Dead slots come from the delta side only: every real tombstone at
    # merged position q_j, and its cancelled partner at q_j - 1.
    real_tomb = (dkind == 0) & (drows < n)
    tomb_pos = torch.where(real_tomb, q, big)
    prev_pos = torch.clamp(tomb_pos - 1, 0, big - 1)
    partner_ok = real_tomb & (m_rows[prev_pos] == drows) & (m_cols[prev_pos] == dcols)
    cancel_pos = torch.where(partner_ok, prev_pos, big)
    dpos = torch.sort(torch.cat([tomb_pos, cancel_pos])).values

    # Compaction shift: final slot j takes merged[j + |{k: dpos_k - k <= j}|]
    adj = dpos - torch.arange(2 * d, device=dev)
    ind2 = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    ind2.index_add_(0, torch.clamp(adj, 0, cap), (dpos < big).long())
    shift = torch.cumsum(ind2, 0)[:cap]
    sel = torch.clamp(torch.arange(cap, device=dev) + shift, max=big - 1)
    rows, cols = m_rows[sel], m_cols[sel]
    pad = rows >= n
    rows = torch.where(pad, n, rows).to(torch.int32)
    cols = torch.where(pad, n, cols).to(torch.int32)
    w = torch.where(pad, 0.0, m_w[sel]) if weighted else None
    return EdgeStore(rows=rows, cols=cols, num_edges=(rows < n).sum(), num_nodes=n, weights=w)


def edge_store_to_csr(store: EdgeStore, device=None) -> CSR:
    """The store as a CSR on ``device`` (default ``cuda``): ``indptr`` from
    a per-row count, edge ids positional, as the reference's
    ``label_edges`` relabels them. Because the store is (row, col)-sorted,
    ``store.weights`` is the snapshot's CSR-order weight array. A device
    store is copied to the host first (the CSR keeps a host mirror)."""
    n = int(store.num_nodes)
    rows = store.rows.cpu().numpy() if torch.is_tensor(store.rows) else np.asarray(store.rows)
    cols = store.cols.cpu().numpy() if torch.is_tensor(store.cols) else np.asarray(store.cols)
    capacity = rows.shape[0]
    valid = rows < n
    counts = np.bincount(rows[valid], minlength=n)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    eids = np.where(valid, np.arange(capacity, dtype=np.int32), np.int32(capacity))
    return CSR((indptr, rows, cols, eids), n, int(valid.sum()), resolve_device(device))


class DeltaGraph(DynamicGraph):
    """Dynamic graph driven by delta replay.

    The add/delete lists of every timestamp are staged on ``device``
    (default ``cuda``), padded to the largest delta with the sentinel
    ``num_nodes``; the snapshots are made on the host by replaying them
    with ``apply_delta`` on CPU tensors. ``edge_weight_lists`` makes the store
    weighted: a weight change on a persisting edge is a delete + add pair.
    """

    def __init__(
        self,
        edge_lists: Sequence[Sequence[Tuple[int, int]]],
        edge_weight_lists: Optional[Sequence[Sequence[float]]] = None,
        capacity: Optional[int] = None,
        pad_multiple: int = 8,
        device=None,
    ) -> None:
        super().__init__(edge_lists, edge_weight_lists)
        self._device = resolve_device(device)
        n = self._num_nodes
        weighted = edge_weight_lists is not None
        self._weighted = weighted
        if capacity is None:
            capacity = round_up(max(self.max_num_edges, 1), pad_multiple)
        self._capacity = capacity

        max_add = round_up(max(max((len(d["add"]) for d in self._deltas), default=0), 1), pad_multiple)
        max_del = round_up(max(max((len(d["delete"]) for d in self._deltas), default=0), 1), pad_multiple)

        def _pad(arr: np.ndarray, cap: int) -> np.ndarray:
            out = np.full((cap, 2), n, dtype=np.int32)
            out[: len(arr)] = arr
            return out

        staged_add = np.stack([_pad(d["add"], max_add) for d in self._deltas])
        staged_del = np.stack([_pad(d["delete"], max_del) for d in self._deltas])
        staged_add_w = None
        if weighted:
            staged_add_w = np.zeros((self._num_timestamps, max_add), np.float32)
            for t, dlt in enumerate(self._deltas):
                staged_add_w[t, : len(dlt["add_w"])] = dlt["add_w"]
        self._staged_add = torch.from_numpy(staged_add).to(self._device)
        self._staged_del = torch.from_numpy(staged_del).to(self._device)
        self._staged_add_w = None if staged_add_w is None else torch.from_numpy(staged_add_w).to(self._device)

        self._snapshots: List[EdgeStore] = []
        empty = self.snapshot_store(-1)
        state = EdgeStore(torch.from_numpy(empty.rows), torch.from_numpy(empty.cols), torch.tensor(0), n,
                          None if empty.weights is None else torch.from_numpy(empty.weights))
        add_t, del_t = torch.from_numpy(staged_add), torch.from_numpy(staged_del)
        for t in range(self._num_timestamps):
            state = apply_delta(
                state,
                add_t[t, :, 1],  # row = dst
                add_t[t, :, 0],  # col = src
                del_t[t, :, 1],
                del_t[t, :, 0],
                add_weights=None if not weighted else torch.from_numpy(staged_add_w[t]),
            )
            self._snapshots.append(EdgeStore(
                rows=state.rows.numpy(), cols=state.cols.numpy(), num_edges=np.int32(state.num_edges),
                num_nodes=n, weights=None if state.weights is None else state.weights.numpy()))
        self._csr_cache: Dict[int, CSR] = {}

    def graph_type(self) -> str:
        return "delta"

    def get_graph(self, timestamp: int) -> CSR:
        if timestamp not in self._csr_cache:
            self._csr_cache[timestamp] = edge_store_to_csr(self._snapshots[timestamp], self._device)
        return self._csr_cache[timestamp]

    def get_backward_graph(self, timestamp: int) -> CSR:
        return self.get_graph(timestamp).transpose()

    def get_edge_weights(self, timestamp: int) -> Optional[torch.Tensor]:
        """(capacity, 1) snapshot weights in CSR edge order (= store order,
        and, the eids being positional, user order too), or None."""
        if not self._weighted:
            return None
        return torch.from_numpy(self._snapshots[timestamp].weights.reshape(-1, 1)).to(self._device)

    def staged_deltas(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """((T, A, 2) additions, (T, D, 2) deletions) on the device; each row
        is (src, dst), padding rows carry the sentinel ``num_nodes``."""
        return self._staged_add, self._staged_del

    def staged_add_weights(self) -> Optional[torch.Tensor]:
        """(T, A) f32 weights of the staged additions, or None."""
        return self._staged_add_w

    def snapshot_store(self, timestamp: int) -> EdgeStore:
        """The host (numpy) edge store after replaying deltas 0..timestamp;
        ``timestamp = -1`` gives the empty initial store."""
        if timestamp < 0:
            n = self._num_nodes
            return EdgeStore(
                rows=np.full((self._capacity,), n, np.int32),
                cols=np.full((self._capacity,), n, np.int32),
                num_edges=np.int32(0),
                num_nodes=n,
                weights=np.zeros((self._capacity,), np.float32) if self._weighted else None,
            )
        return self._snapshots[timestamp]
