"""Segment reductions and segment softmax — the numerical core.

Counterpart of ``stgraph_tpu/ops/segment.py``, in plain torch ops. All
functions take CSR-ordered edge data (sorted by destination row).

JAX drops segment ids equal to ``num_segments`` by its scatter semantics;
``index_add_`` and ``scatter_reduce_`` raise on them instead. So every
reduction here masks those entries explicitly (together with ``edge_mask``)
and clamps their ids before scattering. ``gather_rows`` gives a gather the
semantics of XLA's: an out-of-range id reads the last row, and its
gradient is dropped. The conventions match the JAX package: empty segments
give 0 for max and min, and mean divides by ``max(count, 1)``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "gather_rows",
    "segment_sum",
    "segment_max",
    "segment_min",
    "segment_mean",
    "segment_softmax",
    "broadcast_to_edges",
]


class _ClampedGather(torch.autograd.Function):
    """``x[clamp(ids)]`` whose backward drops the out-of-range ids, as the
    scatter that differentiates XLA's gather does."""

    @staticmethod
    def forward(ctx, x, ids, ids_clamped):
        ctx.save_for_backward(ids, ids_clamped)
        ctx.num_rows = x.shape[0]
        return x[ids_clamped]

    @staticmethod
    def backward(ctx, g):
        ids, ids_clamped = ctx.saved_tensors
        valid = ids < ctx.num_rows
        gx = g.new_zeros((ctx.num_rows,) + tuple(g.shape[1:]))
        return gx.index_add(0, ids_clamped[valid], g[valid]), None, None


def gather_rows(
    x: torch.Tensor, ids: torch.Tensor, ids_clamped: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``x[ids]`` where ids may equal ``x.shape[0]`` (the padding sentinel):
    such an id reads the last row, and no gradient flows back through it.
    ``ids_clamped`` may pass a cached ``ids.clamp(max=len(x) - 1)``."""
    if ids_clamped is None:
        ids_clamped = _clamped(ids, x.shape[0])
    if torch.is_grad_enabled() and x.requires_grad:
        return _ClampedGather.apply(x, ids, ids_clamped)
    return x[ids_clamped]


def _valid(segment_ids, num_segments, edge_mask):
    valid = segment_ids < num_segments
    if edge_mask is not None:
        valid = valid & edge_mask
    return valid


def _clamped(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    return segment_ids.clamp(max=max(num_segments - 1, 0)).long()


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sum ``data`` rows into ``num_segments`` buckets by ``segment_ids``.

    Entries with an out-of-range id or a False ``edge_mask`` contribute
    nothing, whatever their value (NaN included).
    """
    valid = _valid(segment_ids, num_segments, edge_mask)
    data = torch.where(_expand(valid, data), data, torch.zeros((), dtype=data.dtype, device=data.device))
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add(0, _clamped(segment_ids, num_segments), data)


def _segment_extreme(data, segment_ids, num_segments, edge_mask, reduce, fill):
    valid = _valid(segment_ids, num_segments, edge_mask)
    fill_t = torch.full((), fill, dtype=data.dtype, device=data.device)
    data = torch.where(_expand(valid, data), data, fill_t)
    idx = _expand(_clamped(segment_ids, num_segments), data).expand_as(data)
    out = torch.full(
        (num_segments,) + tuple(data.shape[1:]), fill, dtype=data.dtype, device=data.device
    )
    out = out.scatter_reduce(0, idx, data, reduce, include_self=True)
    return torch.where(out == fill_t, torch.zeros_like(out), out)


def segment_max(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment maximum. Empty segments produce 0. Tied maxima share the
    gradient evenly, as ``jax.ops.segment_max`` does."""
    return _segment_extreme(data, segment_ids, num_segments, edge_mask, "amax", float("-inf"))


def segment_min(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment minimum. Empty segments produce 0."""
    return _segment_extreme(data, segment_ids, num_segments, edge_mask, "amin", float("inf"))


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment mean: sum divided by ``max(count, 1)``; empty → 0."""
    s = segment_sum(data, segment_ids, num_segments, edge_mask)
    ones = torch.ones(segment_ids.shape[:1], dtype=data.dtype, device=data.device)
    counts = segment_sum(ones, segment_ids, num_segments, edge_mask).clamp(min=1.0)
    return s / _expand(counts, s)


def segment_softmax(
    scores: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    edge_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Numerically-stable per-segment softmax over edges (the per-segment
    max is subtracted before ``exp``)."""
    m = segment_max(scores, segment_ids, num_segments, edge_mask)
    e = torch.exp(scores - gather_rows(m, segment_ids))
    if edge_mask is not None:
        e = torch.where(_expand(edge_mask, e), e, torch.zeros_like(e))
    denom = segment_sum(e, segment_ids, num_segments)
    denom = denom.clamp(min=torch.finfo(scores.dtype).tiny)
    return e / gather_rows(denom, segment_ids)


def broadcast_to_edges(node_vals: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """Gather per-node values back to edge positions (dest broadcast)."""
    return gather_rows(node_vals, segment_ids)


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Reshape a (E,) tensor to broadcast against (E, ...) data."""
    return mask.reshape(tuple(mask.shape) + (1,) * (like.dim() - 1))
