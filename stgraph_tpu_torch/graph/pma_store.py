"""PMA-style chunked edge store: O(delta) updates with slack kept in place.

Counterpart of ``stgraph_tpu/graph/pma_store.py``, on torch tensors:

  * capacity is split into C chunks of S slots; each chunk holds a sorted
    run of (row, col) keys with sentinel padding (row == n) at its tail,
    and the chunks are globally ordered. The sentinels between chunks are
    the slack;
  * ``apply_delta_pma`` sorts the delta batch, routes it to its chunks by a
    binary search over the chunk-minimum keys, and merges only the affected
    chunks: the flat store's merge, cancel and compact (``delta_graph``) at
    chunk scale, batched over the affected chunks;
  * when a chunk would overflow, or takes more deltas than its workspace
    (``too_hot``), the step takes the rebuild branch instead: compact every
    live entry, apply the delta with the flat ``apply_delta``, and spread
    the result evenly over the chunks (the PMA rebalance; a store of twice
    the chunks its edges need sits at about 50 % density).

What differs from JAX, and why:

  * JAX picks the branch inside ``lax.cond``. Here the overflow flag is
    read on the host once a step (one device sync a store a step: two a
    timestep for a pair), and only the branch taken runs; ``apply_delta_pma.rebuilds`` counts the rebuilds;
  * every update is out of place: each timestep's store is a new object and
    no tensor of an earlier one is written, so a forward's saved store is
    still its timestep's graph when the backward runs;
  * keys are (row, col) pairs packed into one int64 (``pack_keys``), so
    each bisection is one ``torch.searchsorted`` where JAX bisects the pairs
    by hand; the positions are the same.

After every step the layout, ``counts`` and ``num_edges`` are the JAX
store's, array for array, in both branches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from stgraph_tpu_torch.graph.delta_graph import EdgeStore, apply_delta, pack_keys
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["PMAStore", "apply_delta_pma", "pma_from_edges", "pma_init"]


@dataclass(frozen=True)
class PMAStore:
    """Chunked sorted edge store. Keys are (row, col); sentinel row == n."""

    rows: torch.Tensor  # (C, S) int32, per-chunk sorted, tail sentinels
    cols: torch.Tensor  # (C, S) int32
    counts: torch.Tensor  # (C,) int32 live entries per chunk
    num_edges: torch.Tensor  # () int32
    num_nodes: int
    weights: Optional[torch.Tensor] = None  # (C, S) f32 or None

    @property
    def capacity(self) -> int:
        return self.rows.shape[0] * self.rows.shape[1]

    def flatten(self):
        """(C·S,) rows/cols[/weights] with interspersed sentinel padding."""
        w = None if self.weights is None else self.weights.reshape(-1)
        return self.rows.reshape(-1), self.cols.reshape(-1), w


def pma_init(num_nodes: int, num_chunks: int, chunk_size: int, weighted: bool = False, device=None) -> PMAStore:
    """An empty store on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    n, shape = num_nodes, (num_chunks, chunk_size)
    return PMAStore(
        rows=torch.full(shape, n, dtype=torch.int32, device=dev),
        cols=torch.full(shape, n, dtype=torch.int32, device=dev),
        counts=torch.zeros(num_chunks, dtype=torch.int32, device=dev),
        num_edges=torch.zeros((), dtype=torch.int32, device=dev),
        num_nodes=n,
        weights=torch.zeros(shape, device=dev) if weighted else None,
    )


def _merge_chunks(crows, ccols, cw, drows, dcols, dkind, dw, dmask, n: int, weighted: bool):
    """Merge each (S,) sorted chunk with its (Dc,) masked sorted deltas, for a
    batch of A chunks: bisect merge positions, cancel (entry, tombstone)
    pairs, compact. Returns (rows, cols, w, count, overflow), (A, S) and
    (A,); a chunk keeps its slot count, and ``overflow`` flags a live count
    above S."""
    a, s_len = crows.shape
    dc = drows.shape[1]
    dev = crows.device
    # masked-out delta slots become sentinels (sort high, cancel nothing)
    drows = torch.where(dmask, drows, n)
    dcols = torch.where(dmask, dcols, n)

    p = torch.searchsorted(pack_keys(crows, ccols, n), pack_keys(drows, dcols, n), right=True)
    q = p + torch.arange(dc, device=dev)
    big = s_len + dc
    ind = torch.zeros(a, big + 1, dtype=torch.int64, device=dev)
    ind.scatter_add_(1, torch.clamp(q + 1, max=big), torch.ones_like(q))
    t = torch.cumsum(ind, 1)[:, :big]
    tc = torch.clamp(t, max=dc - 1)
    i = torch.arange(big, device=dev)
    is_delta = torch.gather(q, 1, tc) == i
    sidx = torch.clamp(i - t, 0, s_len - 1)
    m_rows = torch.where(is_delta, torch.gather(drows, 1, tc), torch.gather(crows, 1, sidx))
    m_cols = torch.where(is_delta, torch.gather(dcols, 1, tc), torch.gather(ccols, 1, sidx))
    if weighted:
        m_w = torch.where(is_delta, torch.gather(dw, 1, tc), torch.gather(cw, 1, sidx))

    real_tomb = dmask & (dkind == 0) & (drows < n)
    tomb_pos = torch.where(real_tomb, q, big)
    prev_pos = torch.clamp(tomb_pos - 1, min=0)
    partner_ok = real_tomb & (torch.gather(m_rows, 1, prev_pos) == drows) & (
        torch.gather(m_cols, 1, prev_pos) == dcols)
    cancel_pos = torch.where(partner_ok, prev_pos, big)
    dpos = torch.sort(torch.cat([tomb_pos, cancel_pos], 1), dim=1).values
    adj = dpos - torch.arange(2 * dc, device=dev)
    ind2 = torch.zeros(a, s_len + 1, dtype=torch.int64, device=dev)
    ind2.scatter_add_(1, torch.clamp(adj, 0, s_len), (dpos < big).long())
    shift = torch.cumsum(ind2, 1)[:, :s_len]
    sel = torch.clamp(torch.arange(s_len, device=dev) + shift, max=big - 1)
    rows = torch.gather(m_rows, 1, sel)
    cols = torch.gather(m_cols, 1, sel)
    pad = rows >= n
    rows = torch.where(pad, n, rows).to(torch.int32)
    cols = torch.where(pad, n, cols).to(torch.int32)
    count = (rows < n).sum(1).to(torch.int32)
    # a live entry compacted past slot S - 1 would be lost: the merged live
    # length is (previous live) + adds - cancelled - tombstones
    live_total = ((crows < n).sum(1) + (dmask & (dkind == 1) & (drows < n)).sum(1)
                  - (cancel_pos < big).sum(1) - (tomb_pos < big).sum(1))
    w_out = torch.where(pad, 0.0, torch.gather(m_w, 1, sel)) if weighted else None
    return rows, cols, w_out, count, live_total > s_len


def _redistribute(rows_f, cols_f, w_f, n: int, c: int, s: int, weighted: bool):
    """Compact every live entry of the flat (C·S,) arrays (globally sorted
    once the sentinels are dropped) and spread them evenly over the chunks,
    ``ceil(live / C)`` a chunk: the PMA rebalance."""
    cap = rows_f.shape[0]
    dev = rows_f.device
    alive = rows_f < n
    rank = torch.cumsum(alive, 0) - 1
    total = alive.sum()
    fill = torch.clamp((total + c - 1) // c, 1, s)
    tgt_chunk = torch.div(rank, fill, rounding_mode="floor")
    dst = tgt_chunk * s + (rank - tgt_chunk * fill)
    dst = torch.where(alive, dst, cap).clamp(max=cap)  # slot cap takes what is dropped

    def spread(vals, fill_value):
        out = torch.full((cap + 1,), fill_value, dtype=vals.dtype, device=dev)
        return out.scatter_(0, dst, vals)[:cap].reshape(c, s)

    rows2, cols2 = spread(rows_f, n), spread(cols_f, n)
    counts = (rows2 < n).sum(1).to(torch.int32)
    w2 = spread(w_f, 0.0) if weighted else None
    return rows2, cols2, w2, counts, total.to(torch.int32)


def apply_delta_pma(
    store: PMAStore,
    add_rows: torch.Tensor,
    add_cols: torch.Tensor,
    del_rows: torch.Tensor,
    del_cols: torch.Tensor,
    add_weights: Optional[torch.Tensor] = None,
) -> PMAStore:
    """Batch add/delete with chunk-local merges; a new store.

    The contract of ``delta_graph.apply_delta``: the batches are padded with
    the sentinel ``num_nodes``; deletions name existing edges; an addition
    is new or paired with a same-key deletion (a weight update). Reads one
    flag on the host (whether to rebuild).
    """
    n = store.num_nodes
    c, s = store.rows.shape
    dev = store.rows.device
    weighted = store.weights is not None
    dd, da = del_rows.shape[0], add_rows.shape[0]
    d = dd + da

    drows = torch.cat([del_rows, add_rows]).to(device=dev, dtype=torch.int32)
    dcols = torch.cat([del_cols, add_cols]).to(device=dev, dtype=torch.int32)
    dkind = torch.cat([torch.zeros(dd, dtype=torch.int64, device=dev), torch.ones(da, dtype=torch.int64, device=dev)])
    o = torch.sort(pack_keys(drows, dcols, n) * 2 + dkind, stable=True).indices  # (row, col, kind), stable
    drows, dcols, dkind = drows[o], dcols[o], dkind[o]
    if weighted:
        aw = (torch.ones(da, device=dev) if add_weights is None
              else add_weights.reshape(-1).to(device=dev, dtype=torch.float32))
        dw = torch.cat([torch.zeros(dd, device=dev), aw])[o]
    else:
        dw = torch.zeros(d, device=dev)
    real = drows < n

    # Route each delta to the last chunk whose minimum key is <= its key
    # (clamped to 0). An empty chunk inherits the next nonempty chunk's
    # minimum (a suffix minimum), so the routing keys stay sorted.
    lo = pack_keys(torch.where(store.counts > 0, store.rows[:, 0], n),
                   torch.where(store.counts > 0, store.cols[:, 0], n), n)
    lo = torch.flip(torch.cummin(torch.flip(lo, [0]), 0).values, [0])
    pos = torch.searchsorted(lo, pack_keys(drows, dcols, n), right=True)
    cid = torch.where(real, torch.clamp(pos - 1, 0, c - 1), c)  # padding routes nowhere

    # The affected chunks: the first delta of each chunk id, compacted into
    # a workspace of A = min(d, C) slots (slot A takes what is dropped).
    a = min(d, c)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), cid[1:] != cid[:-1]]) & real
    a_rank = torch.cumsum(first, 0) - 1
    n_aff = first.sum()
    slot = torch.where(first, torch.clamp(a_rank, max=a - 1), a)
    slot_cid = torch.full((a + 1,), c, dtype=torch.int64, device=dev).scatter_(0, slot, cid)[:a]
    starts = torch.zeros(a + 1, dtype=torch.int64, device=dev).scatter_(0, slot, torch.arange(d, device=dev))[:a]
    aff = torch.arange(a, device=dev)
    ends = torch.cat([starts[1:], starts.new_zeros(1)])
    ends = torch.where(aff + 1 < n_aff, ends, d)
    ends = torch.where(aff < n_aff, ends, starts)  # empty slots

    # Each chunk's delta workspace is Dc slots; a hotter chunk takes the
    # rebuild branch.
    dc = min(d, s)
    too_hot = ((ends - starts) > dc).any()
    idx = starts[:, None] + torch.arange(dc, device=dev)  # into the deltas padded by Dc zeros

    def window(x):
        return torch.cat([x, x.new_zeros(dc)])[idx]

    cidc = torch.clamp(slot_cid, max=c - 1)
    dmask = torch.arange(dc, device=dev) < (ends - starts)[:, None]
    cw = store.weights[cidc] if weighted else None
    m_rows, m_cols, m_w, m_counts, m_over = _merge_chunks(
        store.rows[cidc], store.cols[cidc], cw, window(drows), window(dcols), window(dkind), window(dw), dmask,
        n, weighted)
    active = slot_cid < c
    if not bool(((m_over & active).any() | too_hot).item()):  # the step's one host sync
        tgt = torch.where(active, slot_cid, c)  # row C of the copies takes the idle slots

        def put(base, vals):
            return torch.cat([base, base[:1]]).index_copy_(0, tgt, vals)[:c]

        rows2, cols2, counts2 = put(store.rows, m_rows), put(store.cols, m_cols), put(store.counts, m_counts)
        w2 = put(store.weights, m_w) if weighted else None
        total = counts2.sum().to(torch.int32)
    else:
        # The rebuild: compact to one sorted flat store (apply_delta's
        # bisection needs tail padding, not interspersed sentinels), apply
        # the flat merge, spread the result evenly. O(capacity).
        apply_delta_pma.rebuilds += 1
        rows_f, cols_f, w_f = store.flatten()
        if w_f is None:
            w_f = torch.zeros(rows_f.shape, device=dev)
        r0, c0, w0, _, total0 = _redistribute(rows_f, cols_f, w_f, n, 1, c * s, True)
        out = apply_delta(EdgeStore(r0.reshape(-1), c0.reshape(-1), total0, n,
                                    w0.reshape(-1) if weighted else None),
                          add_rows, add_cols, del_rows, del_cols, add_weights=add_weights)
        ow = out.weights if weighted else torch.zeros(out.rows.shape, device=dev)
        rows2, cols2, w2, counts2, total = _redistribute(out.rows, out.cols, ow, n, c, s, weighted)
    return PMAStore(rows=rows2, cols=cols2, counts=counts2, num_edges=total, num_nodes=n, weights=w2)


apply_delta_pma.rebuilds = 0  # rebuild branches taken since the count was last reset


def pma_from_edges(
    src,
    dst,
    num_nodes: int,
    num_chunks: int,
    chunk_size: int,
    weights: Optional[np.ndarray] = None,
    device=None,
) -> PMAStore:
    """A store from an edge list, ``ceil(E / C)`` edges a chunk (about 50 %
    density at the drivers' C), built on the host and placed on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    n, c, s = num_nodes, num_chunks, chunk_size
    rows = np.asarray(dst, np.int64)
    cols = np.asarray(src, np.int64)
    order = np.argsort(rows << 32 | cols, kind="stable")
    rows, cols = rows[order].astype(np.int32), cols[order].astype(np.int32)
    w = None if weights is None else np.asarray(weights, np.float32)[order]
    e = len(rows)
    if e > c * s:
        raise ValueError("capacity too small")
    fill = min(max((e + c - 1) // c, 1), s)
    out_r = np.full((c, s), n, np.int32)
    out_c = np.full((c, s), n, np.int32)
    out_w = np.zeros((c, s), np.float32) if w is not None else None
    idx = np.arange(e)
    ch, sl = idx // fill, idx % fill
    out_r[ch, sl] = rows
    out_c[ch, sl] = cols
    if out_w is not None:
        out_w[ch, sl] = w
    counts = np.bincount(ch, minlength=c).astype(np.int32)
    return PMAStore(
        rows=torch.from_numpy(out_r).to(dev),
        cols=torch.from_numpy(out_c).to(dev),
        counts=torch.from_numpy(counts).to(dev),
        num_edges=torch.tensor(e, dtype=torch.int32, device=dev),
        num_nodes=n,
        weights=None if out_w is None else torch.from_numpy(out_w).to(dev),
    )
