"""Gather-locality node relabelling (a host-side layout pass).

Counterpart of ``stgraph_tpu/graph/reorder.py``, numpy only. The SpMM's
cost at large N is the per-edge gather of feature rows ``h[cols]`` (K1 and
K2 on the card): at ogbn-products size the bf16 table is 627 MB at F = 128,
far above the H100's 50 MB L2, so with node ids that say nothing of the
graph's structure nearly every gathered row comes from device memory.
Community-clustered graphs touch few distinct rows per CSR region *if* node
ids are assigned so that communities are contiguous. This pass relabels the
nodes by synchronous **label propagation** (each node adopts the most
frequent label among its neighbours, ties to the smaller label, at most 8
rounds), then sorts them stably by (label, id), so each community lands in
one contiguous id range.

The order is computed once per graph, by the port's native builder
(``native.reorder_locality``, C++) when a compiler is there and by the
vectorised numpy fallback ``_lp_order_numpy`` otherwise; the two give the
same order. It is applied by relabelling the edge list and permuting the
node data before the CSR is built, so the kernels see an ordinary CSR.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "gather_working_set",
    "inverse_permutation",
    "locality_order",
    "relabel_edges",
]

_LP_ROUNDS = 8


def inverse_permutation(order: np.ndarray) -> np.ndarray:
    """``new_id`` such that ``new_id[order[k]] == k``."""
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order), dtype=order.dtype)
    return inv


def locality_order(src, dst, num_nodes: int) -> np.ndarray:
    """Locality order: ``order[k]`` is the old id of the node at new
    position ``k`` (int32). Label propagation, then a stable sort by
    (label, id)."""
    src = np.asarray(src, np.int32).reshape(-1)
    dst = np.asarray(dst, np.int32).reshape(-1)
    from stgraph_tpu_torch import native

    order = native.reorder_locality(src, dst, int(num_nodes))
    if order is not None:
        return order
    return _lp_order_numpy(src, dst, int(num_nodes))


def relabel_edges(src: np.ndarray, dst: np.ndarray, order: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """An edge list mapped into the id space that ``order`` defines."""
    new_id = inverse_permutation(np.asarray(order))
    return new_id[np.asarray(src)], new_id[np.asarray(dst)]


def _lp_order_numpy(src: np.ndarray, dst: np.ndarray, n: int, rounds: int = _LP_ROUNDS) -> np.ndarray:
    """Label propagation in numpy, for when no compiler is there.

    The native pass's semantics: synchronous rounds over both directions of
    every edge with both ends in ``[0, n)``, the most frequent neighbour
    label, ties to the smaller label, isolated nodes keep their own; the
    order is a stable sort by (label, id).
    """
    if n == 0:
        return np.empty(0, np.int32)
    valid = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    u = np.concatenate([src[valid], dst[valid]]).astype(np.int64)
    v = np.concatenate([dst[valid], src[valid]]).astype(np.int64)
    labels = np.arange(n, dtype=np.int64)
    for _ in range(rounds):
        keys = u * (n + 1) + labels[v]
        uk, cnt = np.unique(keys, return_counts=True)
        u_of = uk // (n + 1)
        l_of = uk % (n + 1)
        # per node the largest count, ties to the smallest label: sorted by
        # (node, count, -label), the winner comes last in its node's group
        idx = np.lexsort((-l_of, cnt, u_of))
        u_s, l_s = u_of[idx], l_of[idx]
        last = np.r_[u_s[1:] != u_s[:-1], True]
        new_labels = labels.copy()
        new_labels[u_s[last]] = l_s[last]
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return np.argsort(labels, kind="stable").astype(np.int32)


def gather_working_set(
    dst: np.ndarray,
    src: np.ndarray,
    num_nodes: int,
    region_edges: int = 1 << 20,
    row_bytes: int = 512,
) -> float:
    """Mean bytes of distinct source rows per CSR region.

    A measure of the gather's locality: the edges are taken in (dst, src)
    CSR order, cut into regions of ``region_edges``, and a region costs its
    number of distinct source rows times ``row_bytes``. Lower is better:
    the region's gathers touch a smaller part of the table. Edges already
    in that order (a CSR's host arrays) are not sorted again; a region's
    rows are counted on a bitmap of the ids.
    """
    dst = np.asarray(dst)
    src = np.asarray(src)
    if len(src) == 0:
        return 0.0
    dd = np.diff(dst)
    if not (np.all(dd >= 0) and np.all((dd > 0) | (np.diff(src) >= 0))):
        src = src[np.lexsort((src, dst))]
    base = min(int(src.min()), 0)
    seen = np.zeros(max(num_nodes, int(src.max()) + 1) - base, bool)
    sizes = []
    for lo in range(0, len(src), region_edges):
        ids = src[lo : lo + region_edges] - base
        seen[ids] = True
        sizes.append(int(np.count_nonzero(seen)) * row_bytes)
        seen[ids] = False
    return float(np.mean(sizes))
