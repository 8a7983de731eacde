"""Distributed dynamic graphs: shard-local delta replay over a mesh's
``graph`` group.

Counterpart of ``stgraph_tpu/parallel/dyn.py``: destination-range edge
partitioning, the ownership rule of ``partition.py``, applied to an evolving
graph:

  * every edge belongs to the shard that owns its destination row, so each
    timestep's delta batch is routed to its shards on the host, once, for
    all timesteps (``partition_dynamic``, host numpy, the JAX function's
    arrays exactly);
  * each rank carries its shard's flat ``EdgeStore`` (``graph/delta_graph``)
    and replays its delta slice with ``apply_delta``: no traffic between
    ranks for structure updates (``dist_dyn_apply_delta``);
  * aggregation all-gathers the row-sharded feature table over the
    ``graph`` group each step and runs K6 (``ops.rowid_kernels.spmm_rowid``)
    on the shard's local row ids over the gathered table, which has P·Ns
    rows where the output has Ns (``dist_dyn_spmm``). A mutating edge set has
    no precomputed halo, so whole rows are shipped;
  * degrees are K7's count of the shard's live slots (``dist_dyn_degree``).

Where JAX runs one ``shard_map`` over stacked (P, ...) arrays, every
function here runs on each rank for its own shard, and the collectives are
explicit: ``shard_dyn_arrays`` gives this rank's carry and staged deltas on
its device, since torch has no sharded ``device_put``. JAX's ``use_kernel``
switch and its ``ns < 2**24`` limit are TPU matters: K6 and K7 run on CUDA
tensors, their plain versions on CPU tensors.

The backward of ``dist_dyn_spmm`` follows JAX's ``_shard_agg`` VJP: the
gathered rows' cotangent is ``w · gout[local_r]``, added into rows ``cols``
of the P·Ns table (``index_add_``: the transpose of a gather, which JAX
leaves to XLA outside any kernel), then summed over the ``graph`` group
(``all_reduce``: gloo has no ``reduce_scatter``), and each rank keeps its own
rows, the transpose of the all-gather. Under gloo a CUDA tensor crosses the
group through the host (``mesh.host_staged``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from stgraph_tpu_torch.graph.delta_graph import EdgeStore, apply_delta
from stgraph_tpu_torch.ops.rowid_kernels import dyn_degree, spmm_rowid
from stgraph_tpu_torch.parallel.halo import _axis
from stgraph_tpu_torch.parallel.mesh import host_staged, mesh_device, staged_collective

__all__ = [
    "DistDynGraph",
    "dist_dyn_apply_delta",
    "dist_dyn_degree",
    "dist_dyn_spmm",
    "partition_dynamic",
    "shard_dyn_arrays",
]


class DistDynGraph(NamedTuple):
    """Host-partitioned dynamic graph: per-shard stores and staged deltas,
    numpy arrays stacked over shards (or over (time, shard)).

    Attributes:
      init_rows/init_cols: (P, cap) int32: shard-local initial stores, rows
        are GLOBAL dst ids (each shard's live rows lie in its range),
        sentinel ``num_nodes`` padding; sorted by (row, col) per shard.
      init_w: (P, cap) f32 or None.
      init_ne: (P,) int32 live-edge counts.
      add_steps/del_steps: (T, P, A, 2) / (T, P, D, 2) int32 (src, dst)
        with sentinel-``num_nodes`` padding rows.
      add_w_steps: (T, P, A) f32 or None.
      num_nodes / nodes_per_shard / num_shards / capacity: the layout.
    """

    init_rows: np.ndarray
    init_cols: np.ndarray
    init_w: Optional[np.ndarray]
    init_ne: np.ndarray
    add_steps: np.ndarray
    del_steps: np.ndarray
    add_w_steps: Optional[np.ndarray]
    num_nodes: int
    nodes_per_shard: int
    num_shards: int
    capacity: int

    @property
    def padded_nodes(self) -> int:
        return self.nodes_per_shard * self.num_shards


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def partition_dynamic(
    init_store: EdgeStore,
    staged_add,  # (T, A, 2) global (src, dst), sentinel-padded
    staged_del,  # (T, D, 2)
    staged_add_w,  # (T, A) or None
    num_shards: int,
    capacity: Optional[int] = None,
) -> DistDynGraph:
    """Route the staged deltas and the initial store to their dst-owner
    shards. ``capacity`` (default: the live edges plus every staged
    addition, rounded up to 512) is each shard's store size."""
    n = int(init_store.num_nodes)
    p = num_shards
    ns = -(-n // p)
    rows0, cols0 = _host(init_store.rows), _host(init_store.cols)
    w0 = None if init_store.weights is None else _host(init_store.weights)
    staged_add, staged_del = _host(staged_add), _host(staged_del)
    staged_add_w = None if staged_add_w is None else _host(staged_add_w)
    live = rows0 < n
    if capacity is None:
        # worst case: every addition lands on one shard
        capacity = max(((int(live.sum()) + staged_add.shape[0] * staged_add.shape[1]) + 511) // 512 * 512, 512)

    init_r = np.full((p, capacity), n, np.int32)
    init_c = np.full((p, capacity), n, np.int32)
    init_wp = None if w0 is None else np.zeros((p, capacity), np.float32)
    init_ne = np.zeros((p,), np.int32)
    for pp in range(p):
        sel = live & (rows0 // ns == pp)
        k = int(sel.sum())
        if k > capacity:
            raise ValueError("per-shard capacity too small for initial store")
        init_r[pp, :k] = rows0[sel]
        init_c[pp, :k] = cols0[sel]
        if init_wp is not None:
            init_wp[pp, :k] = w0[sel]
        init_ne[pp] = k

    def route(steps, w_steps=None):
        t, d, _ = steps.shape
        # a shard's slot budget is the whole batch (it may take all of it)
        out = np.full((t, p, d, 2), n, np.int32)
        out_w = None if w_steps is None else np.zeros((t, p, d), np.float32)
        for tt in range(t):
            dsts = steps[tt, :, 1]
            owner = np.where(dsts < n, dsts // ns, p)
            for pp in range(p):
                sel = owner == pp
                k = int(sel.sum())
                out[tt, pp, :k] = steps[tt, sel]
                if out_w is not None:
                    out_w[tt, pp, :k] = w_steps[tt, sel]
        return out, out_w

    add_p, add_w_p = route(staged_add, staged_add_w)
    del_p, _ = route(staged_del)
    return DistDynGraph(init_rows=init_r, init_cols=init_c, init_w=init_wp, init_ne=init_ne, add_steps=add_p,
                        del_steps=del_p, add_w_steps=add_w_p, num_nodes=n, nodes_per_shard=ns, num_shards=p,
                        capacity=capacity)


def shard_dyn_arrays(mesh, ddg: DistDynGraph, axis: str = "graph"):
    """This rank's carry ``(rows, cols, w or None, num_edges)`` and staged
    deltas ``(add (T, A, 2), del (T, D, 2), add_w (T, A) or None)`` on the
    mesh's device."""
    _, r, _ = _axis(mesh, ddg, axis)
    dev = mesh_device(mesh)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    carry = (t(ddg.init_rows[r]), t(ddg.init_cols[r]), None if ddg.init_w is None else t(ddg.init_w[r]),
             t(ddg.init_ne[r]))
    xs = (t(ddg.add_steps[:, r]), t(ddg.del_steps[:, r]),
          None if ddg.add_w_steps is None else t(ddg.add_w_steps[:, r]))
    return carry, xs


def dist_dyn_apply_delta(
    mesh,
    ddg: DistDynGraph,
    rows: torch.Tensor,  # (cap,) this rank's store
    cols: torch.Tensor,
    w: Optional[torch.Tensor],
    ne: torch.Tensor,
    add: torch.Tensor,  # (A, 2) this rank's routed (src, dst) additions
    dele: torch.Tensor,  # (D, 2)
    add_w: Optional[torch.Tensor],  # (A,)
):
    """Replay one timestep's routed delta on this rank's store; returns the
    new ``(rows, cols, w or None, num_edges)``. ``mesh`` is JAX's argument:
    the replay is local."""
    out = apply_delta(EdgeStore(rows, cols, ne, ddg.num_nodes, w), add[:, 1], add[:, 0], dele[:, 1], dele[:, 0],
                      add_weights=add_w)  # row = dst
    return out.rows, out.cols, out.weights, out.num_edges


def _local_rows(rows: torch.Tensor, ddg: DistDynGraph, r: int) -> torch.Tensor:
    """Global dst ids as this shard's row ids; sentinel ``nodes_per_shard``."""
    ns = ddg.nodes_per_shard
    return torch.where(rows < ddg.num_nodes, rows - r * ns, ns).to(torch.int32)


def _all_gather_rows(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ``graph`` group's shards stacked in rank order: (P·Ns, F)."""
    if size == 1:
        return x
    staged = host_staged(group, x.device)
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


class _DistDynSpmm(torch.autograd.Function):
    """All-gather then K6 forward; JAX's ``_shard_agg`` VJP backward."""

    @staticmethod
    def forward(ctx, feats, rows, cols, w, ddg, group, r, size):
        local_r = _local_rows(rows, ddg, r)
        table = _all_gather_rows(feats.to(torch.float32), group, size)
        ctx.save_for_backward(local_r, cols, w)
        ctx.layout = (ddg.nodes_per_shard, group, r, size)
        return spmm_rowid(local_r, cols, w, table, ddg.nodes_per_shard).to(feats.dtype)

    @staticmethod
    def backward(ctx, gout):
        local_r, cols, w = ctx.saved_tensors
        ns, group, r, size = ctx.layout
        live = local_r < ns
        wl = live.float() if w is None else torch.where(live, w, 0.0)
        msg = gout.float().index_select(0, local_r.long().clamp(max=ns - 1)) * wl[:, None]
        d_table = msg.new_zeros(size * ns, gout.shape[1])
        d_table.index_add_(0, cols.long().clamp(max=size * ns - 1), msg)
        if size > 1:
            staged_collective(dist.all_reduce, d_table, group)
        return d_table[r * ns:(r + 1) * ns].to(gout.dtype), None, None, None, None, None, None, None


def dist_dyn_spmm(
    mesh,
    ddg: DistDynGraph,
    rows: torch.Tensor,  # (cap,) global dst ids, this rank's store
    cols: torch.Tensor,  # (cap,) global src ids
    w: Optional[torch.Tensor],
    feats: torch.Tensor,  # (Ns, F) this rank's rows
    axis: str = "graph",
) -> torch.Tensor:
    """``out[d] = sum w_e * feats[src_e]`` over this rank's evolving shard,
    (Ns, F) in ``feats``' dtype (an f32 stream).

    Source rows come from the table all-gathered over the ``graph`` group;
    the reduction is local (K6), since every destination's in-edges live on
    its owner. Differentiable in ``feats``; edge weights and row ids are
    graph data and get no gradient."""
    group, r, size = _axis(mesh, ddg, axis)
    if feats.shape[0] != ddg.nodes_per_shard:
        raise ValueError(f"feats must be this rank's shard of {ddg.nodes_per_shard} rows, got {tuple(feats.shape)}")
    return _DistDynSpmm.apply(feats, rows, cols, w, ddg, group, r, size)


def dist_dyn_degree(mesh, ddg: DistDynGraph, rows: torch.Tensor, axis: str = "graph") -> torch.Tensor:
    """(Ns, 1) live in-degree of this rank's rows: K7 counting the shard's
    live slots."""
    _, r, _ = _axis(mesh, ddg, axis)
    return dyn_degree(_local_rows(rows, ddg, r), None, ddg.nodes_per_shard)[:, None]
