"""Edge partitioning for multi-device execution: the host half of the
distribution layer.

Counterpart of ``stgraph_tpu/parallel/partition.py``; ``partition_edges``
builds the same arrays from the same edge list, array for array:

  * shard ``p`` owns destination rows ``[p·Ns, (p+1)·Ns)`` and every edge
    pointing into them, so its aggregation is local once the source
    features are present (and GAT's segment softmax is local too);
  * source features live sharded by the same row ranges; the sources a
    shard needs from others arrive as a **halo**, exchanged as P-1 ring
    steps, one per displacement ``d``: step d ships, for every shard q, the
    rows that shard (q+d)%P needs from it, padded to that displacement's
    largest count K_d;
  * every local edge's source is remapped into the ``[own rows (Ns) | halo
    buffer (halo_total)]`` space, so a shard's reduction is an ordinary
    SpMM over a rectangular CSR (``graph.csr.CSR`` with ``num_cols``);
  * per-shard global edge ids (``*_gids``) map each local edge slot back to
    the user's edge order, for per-edge data (weights, attention logits).

Left out are the JAX package's TPU layouts, ``interior_blocked``,
``frontier_blocked``, ``blocked_rows_padded``, the ``*_rowmask`` dicts and
the ``*_cap_pad`` counts (``partition.py:87-96,231-235,279-331``): they
feed Mosaic's block metadata (``RowBlockMeta``) and the blocked layout of
``_shard_blocked``, which nothing calls. Here K1's work items, made once
per shard CSR on the host (``ops.spmm_kernels``), take their place.

The stacked CSRs stay host numpy; ``DistGraph.shard(rank)`` puts one rank's
CSRs on its device. The sorts run on the native counting sort where it
builds (``graph.csr.csr_order``): at ogbn-products size (123.7M edges) two
``lexsort`` passes would take minutes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR, csr_order
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["DistGraph", "DistShard", "StackedCSR", "partition_edges"]


class StackedCSR(NamedTuple):
    """Every shard's CSR, stacked on the leading axis (the JAX package's
    CSR pytree stacked by ``tree_map``): ``indptr`` (P, Ns + 1), ``rows``,
    ``cols``, ``eids`` (P, cap) int32, ``num_edges`` (P,) int64. Rows are
    shard-local destinations with the sentinel ``num_nodes`` (= Ns) on
    padding; ``cols`` index ``num_cols`` table rows, 0 on padding."""

    indptr: np.ndarray
    rows: np.ndarray
    cols: np.ndarray
    eids: np.ndarray
    num_edges: np.ndarray
    num_nodes: int
    num_cols: int

    def csr(self, p: int, device: torch.device) -> CSR:
        """Shard ``p``'s CSR on ``device``."""
        host = (self.indptr[p], self.rows[p], self.cols[p], self.eids[p])
        return CSR(host, self.num_nodes, int(self.num_edges[p]), device, num_cols=self.num_cols)


class DistShard:
    """One rank's part of a ``DistGraph`` on its device, each piece made at
    first use: the three CSRs, the ring's send indices, and the slot maps
    that route local-order edge data into interior and frontier order."""

    def __init__(self, dg: "DistGraph", rank: int, device: torch.device) -> None:
        self.dg, self.rank, self.device = dg, rank, device

    @functools.cached_property
    def local_csr(self) -> CSR:
        return self.dg.local_csr.csr(self.rank, self.device)

    @functools.cached_property
    def interior_csr(self) -> CSR:
        return self.dg.interior_csr.csr(self.rank, self.device)

    @functools.cached_property
    def frontier_csr(self) -> CSR:
        return self.dg.frontier_csr.csr(self.rank, self.device)

    @functools.cached_property
    def send_idx(self) -> Tuple[torch.Tensor, ...]:
        """Ring step d's rows to send, ``send_idx[d - 1]`` (K_d,) int64."""
        return tuple(torch.from_numpy(s[self.rank].astype(np.int64)).to(self.device) for s in self.dg.send_idx_by_d)

    def _pos(self, pos: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(pos[self.rank].astype(np.int64)).to(self.device)

    @functools.cached_property
    def interior_pos(self) -> torch.Tensor:
        return self._pos(self.dg.interior_pos)

    @functools.cached_property
    def frontier_pos(self) -> torch.Tensor:
        return self._pos(self.dg.frontier_pos)


@dataclass
class DistGraph:
    """Edge-partitioned graph, stacked over shards on the leading axis.

    Attributes (the JAX ``DistGraph``'s, less its TPU layouts):
      local_csr: rows are shard-local destinations in [0, Ns); cols index
        the concatenated [local rows (Ns) | halo buffer (halo_total)] space.
      interior_csr / frontier_csr: the same edges split by source locality.
        Interior edges read only local rows (cols in [0, Ns)); frontier
        edges read only the halo buffer (cols re-based into
        [0, halo_total)). The split lets the interior reduction run while
        the halo is in flight.
      send_idx_by_d: P-1 (P, K_d) int32 arrays; ring step d ships
        ``send_idx_by_d[d-1][q]``, the q-local rows that shard (q+d)%P
        needs (0-padded; receivers never read padding).
      halo_offsets: (P,) int32, where ring step d's rows land in the halo
        buffer (entry 0 unused).
      local_gids / interior_gids / frontier_gids: (P, cap) int32, the user
        edge id of each slot (``num_global_edges`` on padding).
      interior_pos / frontier_pos: (P, cap) int32, the local slot of each
        interior / frontier slot (the local capacity on padding).
      num_nodes: the global node count; nodes_per_shard: Ns, with
        P·Ns >= num_nodes; halo_total: sum of K_d; num_shards: P.
    """

    local_csr: StackedCSR
    interior_csr: StackedCSR
    frontier_csr: StackedCSR
    send_idx_by_d: Tuple[np.ndarray, ...]
    halo_offsets: np.ndarray
    local_gids: np.ndarray
    interior_gids: np.ndarray
    frontier_gids: np.ndarray
    interior_pos: np.ndarray
    frontier_pos: np.ndarray
    num_nodes: int
    num_global_edges: int
    nodes_per_shard: int
    halo_total: int
    num_shards: int
    _shards: Dict[Tuple[int, torch.device], DistShard] = field(default_factory=dict, repr=False, compare=False)

    @property
    def padded_nodes(self) -> int:
        return self.nodes_per_shard * self.num_shards

    @property
    def comm_rows_per_shard(self) -> int:
        """Halo rows each shard receives (= sends) per exchange: sum of K_d."""
        return self.halo_total

    def shard(self, rank: int, device=None) -> DistShard:
        """Rank ``rank``'s CSRs and index arrays on ``device`` (default
        ``cuda``), made once per (rank, device)."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (rank, dev)
        if key not in self._shards:
            self._shards[key] = DistShard(self, rank, dev)
        return self._shards[key]


def partition_edges(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    num_shards: int,
    pad_multiple: int = 8,
) -> DistGraph:
    """Host-side partitioner: global edge list -> ``DistGraph``."""
    src = np.asarray(src, dtype=np.int64).reshape(-1)
    dst = np.asarray(dst, dtype=np.int64).reshape(-1)
    n_edges = len(src)
    if n_edges and (min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= num_nodes):
        raise ValueError(f"edge ids must lie in [0, num_nodes={num_nodes})")
    p = num_shards
    ns = -(-num_nodes // p)  # ceil
    owner = src // ns  # owner shard of each edge's source
    dst_shard = dst // ns

    # Per-shard edge sets (dst ownership) and halo needs.
    shard_edges: List[np.ndarray] = []
    need: List[List[np.ndarray]] = []  # need[pp][q] = global src ids needed
    for pp in range(p):
        mask = dst_shard == pp
        shard_edges.append(np.flatnonzero(mask))
        needs_q = []
        for q in range(p):
            if q == pp:
                needs_q.append(np.empty(0, np.int64))
                continue
            needs_q.append(np.unique(src[mask & (owner == q)]))
        need.append(needs_q)
    del owner, dst_shard

    def _rup(x):
        return max(((x + pad_multiple - 1) // pad_multiple) * pad_multiple, pad_multiple)

    # Per-displacement halo sizes: ring step d ships q -> (q+d)%P.
    k_by_d = [_rup(max((len(need[(q + d) % p][q]) for q in range(p)), default=0)) for d in range(1, p)]
    off = 0
    halo_offsets = np.zeros(p, np.int32)
    for d in range(1, p):
        halo_offsets[d] = off
        off += k_by_d[d - 1]
    halo_total = max(off, pad_multiple)

    send_idx_by_d = []
    for d in range(1, p):
        s = np.zeros((p, k_by_d[d - 1]), np.int32)
        for q in range(p):
            ids = need[(q + d) % p][q]
            s[q, : len(ids)] = ids - q * ns
        send_idx_by_d.append(s)

    # Remap each shard's sources into [local | halo] space and build the
    # uniformly padded local CSRs, then the interior/frontier split.
    max_e = max((len(e) for e in shard_edges), default=0)
    cap = max(((max_e + 511) // 512) * 512, 512)
    wide = ns + halo_total
    local, gids_l = [], []
    split = []
    max_int = max_fro = 0
    for pp in range(p):
        idx = shard_edges[pp]
        l_dst = dst[idx] - pp * ns
        g_src = src[idx]
        is_local = (g_src // ns) == pp
        l_src = np.empty_like(g_src)
        l_src[is_local] = g_src[is_local] - pp * ns
        # halo position: ns + halo_offsets[d] + rank within need[pp][q],
        # where d = (pp - q) mod P is the ring displacement.
        for q in range(p):
            if q == pp:
                continue
            sel = (~is_local) & ((g_src // ns) == q)
            if not sel.any():
                continue
            d = (pp - q) % p
            l_src[sel] = ns + halo_offsets[d] + np.searchsorted(need[pp][q], g_src[sel])
        arrays, g = _build_local_csr(l_src, l_dst, ns, wide, cap, idx, n_edges)
        local.append(arrays)
        gids_l.append(g)
        split.append((l_src, l_dst, is_local, idx))
        max_int = max(max_int, int(is_local.sum()))
        max_fro = max(max_fro, int((~is_local).sum()))

    cap_int = max(((max_int + 511) // 512) * 512, 512)
    cap_fro = max(((max_fro + 511) // 512) * 512, 512)
    interior, gids_i, frontier, gids_f = [], [], [], []
    for l_src, l_dst, is_local, idx in split:
        arrays, g = _build_local_csr(l_src[is_local], l_dst[is_local], ns, ns, cap_int, idx[is_local], n_edges)
        interior.append(arrays)
        gids_i.append(g)
        # Frontier cols re-based into the (halo_total,) halo buffer space.
        fro = ~is_local
        arrays, g = _build_local_csr(l_src[fro] - ns, l_dst[fro], ns, halo_total, cap_fro, idx[fro], n_edges)
        frontier.append(arrays)
        gids_f.append(g)
    del split

    # Slot maps local -> interior/frontier order, for routing per-edge data
    # (weights) without a second user-order gather at runtime.
    gl = np.stack(gids_l)
    gi, gf = np.stack(gids_i), np.stack(gids_f)
    int_pos, fro_pos = np.empty_like(gi), np.empty_like(gf)
    for pp in range(p):
        inv = np.full(n_edges + 1, cap, np.int32)
        valid = gl[pp] < n_edges
        inv[gl[pp][valid]] = np.flatnonzero(valid).astype(np.int32)
        int_pos[pp] = inv[np.minimum(gi[pp], n_edges)]
        fro_pos[pp] = inv[np.minimum(gf[pp], n_edges)]
    return DistGraph(
        local_csr=_stack(local, ns, wide),
        interior_csr=_stack(interior, ns, ns),
        frontier_csr=_stack(frontier, ns, halo_total),
        send_idx_by_d=tuple(send_idx_by_d),
        halo_offsets=halo_offsets,
        local_gids=gl,
        interior_gids=gi,
        frontier_gids=gf,
        interior_pos=int_pos,
        frontier_pos=fro_pos,
        num_nodes=num_nodes,
        num_global_edges=n_edges,
        nodes_per_shard=ns,
        halo_total=halo_total,
        num_shards=p,
    )


def _stack(shards, ns: int, num_cols: int) -> StackedCSR:
    indptr, rows, cols, eids, num_edges = (np.stack(a) for a in zip(*shards))
    return StackedCSR(indptr, rows, cols, eids, num_edges, ns, num_cols)


def _build_local_csr(
    l_src: np.ndarray,
    l_dst: np.ndarray,
    ns: int,
    num_cols: int,
    cap: int,
    gids: np.ndarray,
    n_edges: int,
):
    """One shard's CSR arrays ``(indptr, rows, cols, eids, num_edges)`` and
    the user edge id of each slot, as the JAX package builds them: edges
    sorted by (dst, src), stable; ``rows`` padded with the sentinel ``ns``,
    ``cols`` with 0 (the row sentinel already drops those slots), ``eids``
    (local input positions) with ``cap``, the user ids with ``n_edges``."""
    e = len(l_src)
    order, indptr = csr_order(l_dst, l_src, ns, num_cols)
    rows = np.full(cap, ns, np.int32)
    cols = np.zeros(cap, np.int32)
    eids = np.full(cap, cap, np.int32)
    g_out = np.full(cap, n_edges, np.int32)
    rows[:e] = l_dst[order]
    cols[:e] = l_src[order]
    eids[:e] = order
    g_out[:e] = gids[order]
    return (indptr, rows, cols, eids, np.int64(e)), g_out
