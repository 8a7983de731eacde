"""Lazy dynamic edge store: O(delta) updates through tombstones and logs.

Counterpart of ``stgraph_tpu/graph/lazy_store.py``, on torch tensors:

  * the MAIN store stays sorted by (row, col) with sentinel padding
    (row == n), the layout the row-id kernels K6 and K7 read directly;
  * deleting a main edge is a tombstone: look the key up (a sorted search
    over the delete batch only) and set ``w = 0`` there; ``w > 0`` is the
    main store's liveness record, and a zero weight adds exactly nothing;
  * an ADDITION is appended to the TAIL log; aggregation adds the logs'
    contributions with a small signed segment sum;
  * an unweighted delete that misses the live main store names a
    tail-resident edge: its key goes onto the ANTI log, with an implicit
    weight of -1 that cancels the tail entry in every sum. A weighted store
    kills the matching tail entry in place instead (an anti entry would
    need the cancelled weight, which a delete does not carry);
  * when a log cannot take the next batch, ``compact`` merges main, tail
    and anti in one sort, sums the signed weights of each key, and ranks
    the survivors to the front.

What differs from JAX, and why:

  * every update is out of place: each timestep's store is a new object
    and no tensor of an earlier one is written, so the backward of each
    timestep sees that timestep's graph;
  * ``tail_count`` and ``anti_count`` are host ints. They advance by the
    static batch widths and reset to 0 on compaction, so whether to compact
    is decided on the host and no step synchronises with the device;
    ``num_edges`` stays a device tensor;
  * the main store carries its (row, col) pairs packed into sorted int64
    ``keys`` (made at build and compaction time, shared by every step in
    between), so a lookup is one ``torch.searchsorted`` where JAX bisects
    the pairs by hand; the positions are the same.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from stgraph_tpu_torch.graph.delta_graph import pack_keys
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["LazyStore", "apply_delta_lazy", "compact", "lazy_from_edges"]


@dataclass(frozen=True)
class LazyStore:
    """Sorted main store + tail/anti logs. Sentinel row == num_nodes.

    ``w`` doubles as the liveness mask: live edges carry their weight (1.0
    when the graph is unweighted), tombstoned and padding slots carry 0.
    Anti-log entries carry an implicit weight of -1. ``num_edges`` counts
    live edges (main and logs).
    """

    rows: torch.Tensor  # (cap,) int32, sorted (row, col), sentinel-padded
    cols: torch.Tensor  # (cap,) int32
    w: torch.Tensor  # (cap,) f32; 0 == dead
    keys: torch.Tensor  # (cap,) int64 packed (row, col), sorted
    tail_rows: torch.Tensor  # (tcap,) int32, sentinel holes
    tail_cols: torch.Tensor  # (tcap,)
    tail_w: torch.Tensor  # (tcap,) f32
    tail_count: int  # slots used, holes included
    anti_rows: torch.Tensor  # (tcap,) int32, keys of implicit weight -1
    anti_cols: torch.Tensor  # (tcap,)
    anti_count: int
    num_edges: torch.Tensor  # () int64, live edges
    num_nodes: int
    weighted: bool

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def tail_capacity(self) -> int:
        return self.tail_rows.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def anti_w(self) -> torch.Tensor:
        """(tcap,) signed weights of the anti log (-1 per live key)."""
        return torch.where(self.anti_rows < self.num_nodes, -1.0, 0.0)


def _empty_logs(t: int, n: int, dev: torch.device) -> dict:
    return dict(
        tail_rows=torch.full((t,), n, dtype=torch.int32, device=dev),
        tail_cols=torch.full((t,), n, dtype=torch.int32, device=dev),
        tail_w=torch.zeros(t, device=dev),
        tail_count=0,
        anti_rows=torch.full((t,), n, dtype=torch.int32, device=dev),
        anti_cols=torch.full((t,), n, dtype=torch.int32, device=dev),
        anti_count=0,
    )


def lazy_from_edges(
    src,
    dst,
    num_nodes: int,
    capacity: int,
    tail_capacity: int,
    weights: Optional[np.ndarray] = None,
    device=None,
) -> LazyStore:
    """Build on the host, rows = dst (the aggregation key), sorted by
    (row, col), and place on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    n = int(num_nodes)
    rows = np.asarray(dst, np.int64)
    cols = np.asarray(src, np.int64)
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    e = len(rows)
    if e > capacity:
        raise ValueError("capacity too small")
    r = np.full(capacity, n, np.int32)
    c = np.full(capacity, n, np.int32)
    w = np.zeros(capacity, np.float32)
    r[:e] = rows
    c[:e] = cols
    w[:e] = 1.0 if weights is None else np.asarray(weights, np.float32)[order]
    r_t, c_t = torch.from_numpy(r).to(dev), torch.from_numpy(c).to(dev)
    return LazyStore(
        rows=r_t,
        cols=c_t,
        w=torch.from_numpy(w).to(dev),
        keys=pack_keys(r_t, c_t, n),
        **_empty_logs(tail_capacity, n, dev),
        num_edges=torch.tensor(e, dtype=torch.int64, device=dev),
        num_nodes=n,
        weighted=weights is not None,
    )


def _sorted_lookup(s_keys: torch.Tensor, q_keys: torch.Tensor, q_live: torch.Tensor):
    """(found, index) of each live query key in the SORTED haystack."""
    p = torch.searchsorted(s_keys, q_keys, right=True)
    cand = torch.clamp(p - 1, min=0)
    return (s_keys[cand] == q_keys) & q_live, cand


def compact(store: LazyStore) -> LazyStore:
    """Merge the logs into the main store (the amortised O(cap) step).

    One sort of main (dead slots' keys set to the sentinel), tail and anti
    entries by (row, col); the signed weights of each equal-key run are
    summed (a live main edge gives its weight, a tail add +w, an anti
    delete -1); the first entry of each run whose sum is positive is ranked
    to the front. The result is exactly sorted, duplicate-free and
    sentinel-padded, every weight live.
    """
    n = store.num_nodes
    t = store.tail_capacity
    cap = store.capacity
    dev = store.device
    big = cap + 2 * t
    dead = store.w <= 0
    r_all = torch.cat([torch.where(dead, n, store.rows).to(torch.int32), store.tail_rows, store.anti_rows])
    c_all = torch.cat([torch.where(dead, n, store.cols).to(torch.int32), store.tail_cols, store.anti_cols])
    w_all = torch.cat([store.w, store.tail_w, store.anti_w()])
    k_sorted, o = torch.sort(pack_keys(r_all, c_all, n), stable=True)
    r, c, w = r_all[o], c_all[o], w_all[o]
    first = torch.ones(big, dtype=torch.bool, device=dev)
    first[1:] = k_sorted[1:] != k_sorted[:-1]
    rid = torch.cumsum(first, 0) - 1
    net = torch.zeros(big, device=dev).index_add_(0, rid, w)[rid]
    keep = first & (r < n) & (net > 0)
    rank = torch.cumsum(keep, 0) - 1
    # Rank-scatter keeps sorted order; slot `cap` takes everything dropped
    # (entries not kept and, on an overfull store, the excess).
    pos = torch.where(keep & (rank < cap), rank, cap)

    def scatter(fill, values):
        out = torch.full((cap + 1,), fill, dtype=values.dtype, device=dev)
        out[pos] = values
        return out[:cap]

    return LazyStore(
        rows=scatter(n, r),
        cols=scatter(n, c),
        w=scatter(0.0, net),
        keys=scatter(n * (n + 1) + n, k_sorted),
        **_empty_logs(t, n, dev),
        num_edges=torch.clamp(keep.sum(), max=cap),
        num_nodes=n,
        weighted=store.weighted,
    )


def apply_delta_lazy(
    store: LazyStore,
    add_rows: torch.Tensor,
    add_cols: torch.Tensor,
    del_rows: torch.Tensor,
    del_cols: torch.Tensor,
    add_weights: Optional[torch.Tensor] = None,
) -> LazyStore:
    """O(delta) update; returns a new store and writes nothing of ``store``.

    Same contract as ``delta_graph.apply_delta``: sentinel-padded batches;
    deletions name existing edges; an addition is new or paired with a
    same-key deletion (weight update). ``add_weights`` must be strictly
    positive (``w == 0`` is the tombstone). A batch may not exceed
    ``tail_capacity``.
    """
    n = store.num_nodes
    t = store.tail_capacity
    d_del, d_add = del_rows.shape[0], add_rows.shape[0]
    if d_del > t or d_add > t:
        raise ValueError(
            f"delta batch ({d_add} adds / {d_del} dels) exceeds "
            f"tail_capacity={t}; the logs cannot hold one batch"
        )
    # Compact first if a log cannot absorb this batch (host ints: no sync)
    if store.tail_count + d_add > t or store.anti_count + d_del > t:
        store = compact(store)
    dev = store.device
    cap = store.capacity
    del_rows = del_rows.to(device=dev, dtype=torch.int32)
    del_cols = del_cols.to(device=dev, dtype=torch.int32)
    add_rows = add_rows.to(device=dev, dtype=torch.int32)
    add_cols = add_cols.to(device=dev, dtype=torch.int32)
    aw = (torch.where(add_rows < n, 1.0, 0.0) if add_weights is None
          else add_weights.reshape(-1).to(device=dev, dtype=torch.float32))
    q_keys = pack_keys(del_rows, del_cols, n)
    m_found, m_cand = _sorted_lookup(store.keys, q_keys, del_rows < n)

    # --- deletions ----------------------------------------------------------
    tail_rows, tail_cols, tail_w = store.tail_rows, store.tail_cols, store.tail_w
    anti_rows, anti_cols, anti_count = store.anti_rows, store.anti_cols, store.anti_count
    if store.weighted:
        # Kill matching live tail entries in place: bisect every tail entry
        # into the sorted delete batch.
        sq_keys, qo = torch.sort(q_keys, stable=True)
        kill, t_cand = _sorted_lookup(sq_keys, pack_keys(tail_rows, tail_cols, n), tail_rows < n)
        tail_rows = torch.where(kill, n, tail_rows).to(torch.int32)
        tail_cols = torch.where(kill, n, tail_cols).to(torch.int32)
        tail_w = torch.where(kill, 0.0, tail_w)
        # which deletes a tail kill satisfied, per original slot
        found_sorted = torch.zeros(d_del + 1, dtype=torch.bool, device=dev)
        found_sorted[torch.where(kill, t_cand, d_del)] = True
        t_found = torch.zeros(d_del, dtype=torch.bool, device=dev)
        t_found[qo] = found_sorted[:d_del]
        main_del = m_found & ~t_found
    else:
        # A delete that misses the LIVE main store names a tail-resident
        # edge: its key goes onto the anti log (implicit weight -1). A
        # tombstoned-then-re-added key is still present in main (w = 0), so
        # liveness, not presence, decides.
        main_del = m_found & (store.w[m_cand] > 0)
        anti_valid = (del_rows < n) & ~main_del
        anti_rows, anti_cols = anti_rows.clone(), anti_cols.clone()
        anti_rows[anti_count:anti_count + d_del] = torch.where(anti_valid, del_rows, n)
        anti_cols[anti_count:anti_count + d_del] = torch.where(anti_valid, del_cols, n)
        anti_count += d_del
        t_found = anti_valid  # each anti entry cancels one live log edge

    # The other deletions tombstone MAIN (w = 0); index `cap` takes the rest
    w_ext = torch.empty(cap + 1, device=dev)
    w_ext[:cap] = store.w
    w_ext.index_fill_(0, torch.where(main_del, m_cand, cap), 0.0)
    n_del_live = (t_found | main_del).sum()

    # --- additions: append the batch to the tail -----------------------------
    tc = store.tail_count
    tail_rows, tail_cols, tail_w = tail_rows.clone(), tail_cols.clone(), tail_w.clone()
    tail_rows[tc:tc + d_add] = add_rows
    tail_cols[tc:tc + d_add] = add_cols
    tail_w[tc:tc + d_add] = torch.where(add_rows < n, aw, 0.0)
    return dataclasses.replace(
        store,
        w=w_ext[:cap],
        tail_rows=tail_rows, tail_cols=tail_cols, tail_w=tail_w, tail_count=tc + d_add,
        anti_rows=anti_rows, anti_cols=anti_cols, anti_count=anti_count,
        num_edges=store.num_edges - n_del_live + (add_rows < n).sum(),
    )
