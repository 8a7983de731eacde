"""Differentiable SpMM over the dynamic edge store pairs (PMA and lazy).

Counterpart of ``stgraph_tpu/ops/dyn_spmm.py``. Each pair keeps two stores
of one graph: ``fwd`` keyed by (dst, src) for aggregation, ``bwd`` keyed by
(src, dst) for the gradient's transpose aggregation; both take every delta,
keys swapped.

  * ``PMAGraphPair`` holds two chunked PMA stores (``graph/pma_store.py``).
    ``pma_spmm`` aggregates with K6 (``rowid_kernels.spmm_rowid``) over the
    fwd store's flat (C·S,) view, whose sentinels sit between the chunks,
    and its backward runs K6 over the bwd store's; ``pma_norm`` gives
    ``in_degree^{-1/2}`` from K7 (``rowid_kernels.dyn_degree``) counting the
    fwd store's live slots. JAX pads the flat arrays for its TPU block
    metadata (``_flat_cap_pad``); K6 and K7 take sentinels anywhere and need
    no padding;
  * ``LazyPair`` holds two lazy stores (``graph/lazy_store.py``):
    ``lazy_spmm`` aggregates with K6 over the main store, plus the signed
    tail/anti segment sum; ``lazy_norm`` adds the logs' signed counts to
    K7's.

Edge weights are graph data: they get no gradient. The stores' updates are
out of place, so the store a forward saved is still that timestep's graph
when its backward runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from stgraph_tpu_torch.graph.lazy_store import LazyStore, apply_delta_lazy, lazy_from_edges
from stgraph_tpu_torch.graph.pma_store import PMAStore, apply_delta_pma, pma_from_edges
from stgraph_tpu_torch.ops.rowid_kernels import dyn_degree, spmm_rowid

__all__ = [
    "LazyPair",
    "PMAGraphPair",
    "apply_delta_lazy_pair",
    "apply_delta_pair",
    "lazy_norm",
    "lazy_pair_from_edges",
    "lazy_spmm",
    "pma_norm",
    "pma_pair_from_edges",
    "pma_spmm",
]


class PMAGraphPair(NamedTuple):
    """Dual PMA stores: ``fwd`` keyed by (dst, src), ``bwd`` by (src, dst)."""

    fwd: PMAStore
    bwd: PMAStore

    @property
    def num_nodes(self) -> int:
        return self.fwd.num_nodes


def pma_pair_from_edges(
    src, dst, num_nodes: int, num_chunks: int, chunk_size: int, weights: Optional[np.ndarray] = None, device=None,
) -> PMAGraphPair:
    """Both stores of an edge list, built on the host and placed on
    ``device`` (default ``cuda``)."""
    if chunk_size % 128:
        raise ValueError("chunk_size must be a multiple of 128")
    return PMAGraphPair(
        fwd=pma_from_edges(src, dst, num_nodes, num_chunks, chunk_size, weights=weights, device=device),
        bwd=pma_from_edges(dst, src, num_nodes, num_chunks, chunk_size, weights=weights, device=device),
    )


def apply_delta_pair(pair: PMAGraphPair, add_src, add_dst, del_src, del_dst, add_weights=None) -> PMAGraphPair:
    """One timestep's delta on both stores (keys swapped); a new pair. Two
    host reads of a rebuild flag, one a store."""
    return PMAGraphPair(
        fwd=apply_delta_pma(pair.fwd, add_dst, add_src, del_dst, del_src, add_weights=add_weights),
        bwd=apply_delta_pma(pair.bwd, add_src, add_dst, del_src, del_dst, add_weights=add_weights),
    )


def _pma_one_side(store: PMAStore, feat: torch.Tensor) -> torch.Tensor:
    rows, cols, w = store.flatten()
    return spmm_rowid(rows, cols, w, feat, store.num_nodes)


class _PmaSpmm(torch.autograd.Function):
    """K6 over ``pair.fwd`` forward, over ``pair.bwd`` backward; no weight
    or row-id gradient."""

    @staticmethod
    def forward(ctx, feat, pair):
        ctx.pair = pair
        return _pma_one_side(pair.fwd, feat)

    @staticmethod
    def backward(ctx, g):
        return _pma_one_side(ctx.pair.bwd, g.contiguous()), None


def pma_spmm(pair: PMAGraphPair, node_feat: torch.Tensor) -> torch.Tensor:
    """``out[d] = sum over live (s, d) of w_e * node_feat[s]`` over the pair.

    Differentiable in ``node_feat`` (the backward aggregates on the twin);
    the stream is f32, and the result takes ``node_feat``'s dtype.
    """
    out = _PmaSpmm.apply(node_feat.to(torch.float32), pair)
    return out.to(node_feat.dtype)


def pma_norm(pair: PMAGraphPair) -> torch.Tensor:
    """(N, 1) ``in_degree^{-1/2}`` of the pair, zero degree -> 1: K7 counting
    the fwd store's live slots (the JAX count, ``w=None``: a PMA store keeps
    no tombstones, and a live edge counts whatever its weight)."""
    rows, _, _ = pair.fwd.flatten()
    deg = dyn_degree(rows, None, pair.num_nodes)
    norm = torch.where(deg > 0, torch.clamp(deg, min=1.0).pow(-0.5), 1.0)
    return norm[:, None]


class LazyPair(NamedTuple):
    """Dual lazy stores: ``fwd`` keyed by (dst, src), ``bwd`` by (src, dst)."""

    fwd: LazyStore
    bwd: LazyStore

    @property
    def num_nodes(self) -> int:
        return self.fwd.num_nodes


def lazy_pair_from_edges(
    src, dst, num_nodes: int, capacity: int, tail_capacity: int,
    weights: Optional[np.ndarray] = None, device=None,
) -> LazyPair:
    """Both stores of an edge list, built on the host and placed on
    ``device`` (default ``cuda``)."""
    return LazyPair(
        fwd=lazy_from_edges(src, dst, num_nodes, capacity, tail_capacity, weights=weights, device=device),
        bwd=lazy_from_edges(dst, src, num_nodes, capacity, tail_capacity, weights=weights, device=device),
    )


def apply_delta_lazy_pair(
    pair: LazyPair, add_src, add_dst, del_src, del_dst, add_weights=None
) -> LazyPair:
    """One timestep's delta on both stores (keys swapped); a new pair."""
    return LazyPair(
        fwd=apply_delta_lazy(pair.fwd, add_dst, add_src, del_dst, del_src, add_weights=add_weights),
        bwd=apply_delta_lazy(pair.bwd, add_src, add_dst, del_src, del_dst, add_weights=add_weights),
    )


def _lazy_one_side(store: LazyStore, node_feat: torch.Tensor, n: int) -> torch.Tensor:
    """K6 over the main store + the signed tail/anti segment sum."""
    out = spmm_rowid(store.rows, store.cols, store.w, node_feat, n)
    # Tail and anti logs in one signed segment sum, added into K6's fresh
    # output: anti entries carry an implicit -1, cancelling the tail entry
    # they delete; a dead log slot adds an exact 0 to row n - 1.
    rows, cols, w = _used_logs(store)
    live = rows < n
    t_w = torch.where(live, w, 0.0)
    msg = node_feat.index_select(0, cols.long().clamp(max=n - 1)) * t_w[:, None]
    return out.index_add_(0, rows.long().clamp(max=n - 1), msg)


def _used_logs(store: LazyStore):
    """(rows, cols, signed weights) of the tail and anti logs' used slots:
    the counts are host ints, so the unused slots are never read."""
    t, a = store.tail_count, store.anti_count
    return (torch.cat([store.tail_rows[:t], store.anti_rows[:a]]),
            torch.cat([store.tail_cols[:t], store.anti_cols[:a]]),
            torch.cat([store.tail_w[:t], store.anti_w()[:a]]))


class _LazySpmm(torch.autograd.Function):
    """Forward on ``pair.fwd``, backward on ``pair.bwd``; no weight grad."""

    @staticmethod
    def forward(ctx, feat, pair):
        ctx.pair = pair
        return _lazy_one_side(pair.fwd, feat, pair.num_nodes)

    @staticmethod
    def backward(ctx, g):
        pair = ctx.pair
        return _lazy_one_side(pair.bwd, g.contiguous(), pair.num_nodes), None


def lazy_spmm(pair: LazyPair, node_feat: torch.Tensor) -> torch.Tensor:
    """``out[d] = sum over live (s, d) of w_e * node_feat[s]`` over the pair.

    Differentiable in ``node_feat`` (the backward aggregates on the twin);
    the stream is f32, and the result takes ``node_feat``'s dtype.
    """
    out = _LazySpmm.apply(node_feat.to(torch.float32), pair)
    return out.to(node_feat.dtype)


def lazy_norm(pair: LazyPair) -> torch.Tensor:
    """(N, 1) ``in_degree^{-1/2}`` over the live edges, zero degree -> 1."""
    n = pair.num_nodes
    st = pair.fwd
    deg = dyn_degree(st.rows, st.w, n, indicator=True)  # the live slots: w > 0
    # Signed log counting: a live tail entry counts +1 (weighted entries
    # count 1 whatever their weight), an anti entry -1.
    t_rows, _, t_val = _used_logs(st)
    live = t_rows < n
    if st.weighted:
        t_val = torch.where(t_val > 0, 1.0, t_val)
    deg.index_add_(0, t_rows.long().clamp(max=n - 1), torch.where(live, t_val, 0.0))
    norm = torch.where(deg > 0, torch.clamp(deg, min=1.0).pow(-0.5), 1.0)
    return norm[:, None]
