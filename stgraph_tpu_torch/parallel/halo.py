"""Distributed SpMM and GAT attention: halo exchange + shard-local kernels.

Counterpart of ``stgraph_tpu/parallel/halo.py``, the device half of the
distribution layer (host half: ``parallel/partition.py``). Each rank holds
one shard: its ``Ns`` destination rows of every node array, and the
edges that point into them. Where the JAX package runs one ``shard_map``
program over a mesh axis, every function here runs on each rank of the
mesh's ``graph`` group for its own shard, and the collectives are explicit:

  1. the halo exchange sends each shard's outgoing rows as P-1 ring steps
     (``send_idx_by_d``) with ``torch.distributed.batch_isend_irecv``: step
     d sends to rank (r+d)%P and receives from (r-d)%P into the halo buffer
     at ``halo_offsets[d]``;
  2. the **interior** reduction (edges whose sources are local) is issued
     while the ring's receives are in flight: it never reads the halo;
  3. the frontier reduction runs over the received buffer, and the two are
     added.

``impl='kernel'`` runs each shard reduction on K1's shard mode
(``ops.spmm_cuda.spmm_traced`` over
``ops.spmm_kernels.spmm_rowmask_traced``: K1 on the rectangular transpose
or K2 backward); ``'torch'`` is the plain route. A reduction over a shard
CSR with no edges (the frontier at P = 1) contributes nothing and launches
nothing.

Autodiff. JAX differentiates through ``shard_map``: the ``ppermute``s
transpose to the reverse ring and the halo gather to a scatter-add, so the
gradient's halo reduction is synthesised. Here ``_HaloExchange`` writes it:
its backward sends each received row's cotangent back along the reversed
ring and ``index_add_``s what comes back into the gradient of the rows that
were sent. The replicated parameters' gradients are summed by the caller
(``parallel.layers.reduce_replicated_grads``).

Backends. NCCL moves device tensors. Gloo has no device send/recv, so under
gloo a CUDA tensor is copied to the host before it is sent and back to the
device after it is received, by backend and never on a failure (as two
ranks that share one card must run). On the CPU gloo moves the tensors
themselves.
"""

from __future__ import annotations

from typing import List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from stgraph_tpu_torch.ops import segment as seg
from stgraph_tpu_torch.ops.spmm_cuda import spmm_traced
from stgraph_tpu_torch.parallel.mesh import axis_group, host_staged, mesh_device, staged_collective
from stgraph_tpu_torch.parallel.partition import DistGraph

__all__ = [
    "dist_gat_attention",
    "dist_spmm",
    "replicate",
    "shard_edge_array",
    "shard_node_array",
]

_IMPLS = ("torch", "kernel")


def _axis(mesh, dg: DistGraph, axis: str):
    """``axis_group`` of the mesh axis, which must have a rank a shard."""
    group, rank, size = axis_group(mesh, axis)
    if size != dg.num_shards:
        raise ValueError(f"the {axis!r} axis has {size} ranks, the graph {dg.num_shards} shards")
    return group, rank, size


def shard_node_array(mesh, x, dg: DistGraph, axis: str = "graph") -> torch.Tensor:
    """This rank's ``[r·Ns, (r+1)·Ns)`` rows of the global (N, ...) array
    ``x`` zero-padded to P·Ns rows, on the mesh's device."""
    _, r, _ = _axis(mesh, dg, axis)
    x = torch.as_tensor(x)
    ns = dg.nodes_per_shard
    lo, hi = min(r * ns, x.shape[0]), min((r + 1) * ns, x.shape[0])
    part = x[lo:hi].to(mesh_device(mesh))
    if hi - lo < ns:
        part = torch.cat([part, part.new_zeros((ns - (hi - lo),) + tuple(x.shape[1:]))])
    return part


def shard_edge_array(mesh, w, dg: DistGraph, which: str = "local", axis: str = "graph") -> torch.Tensor:
    """Route global user-order edge data into this rank's slot order.

    Returns the (cap, ...) values of this shard's ``which`` CSR
    (``'local'``, ``'interior'`` or ``'frontier'``), in its slot order, 0 on
    padding, on the mesh's device. Differentiable in ``w``."""
    _, r, _ = _axis(mesh, dg, axis)
    gids = {"local": dg.local_gids, "interior": dg.interior_gids, "frontier": dg.frontier_gids}[which][r]
    w = torch.as_tensor(w).to(mesh_device(mesh))
    e = dg.num_global_edges
    idx = torch.from_numpy(np.minimum(gids, max(e - 1, 0)).astype(np.int64)).to(w.device)
    valid = torch.from_numpy(gids < e).to(w.device)
    out = w[idx]
    return torch.where(valid.reshape((-1,) + (1,) * (out.dim() - 1)), out, torch.zeros_like(out))


def replicate(mesh, x, axis: str = "graph"):
    """``x`` (a tensor or a dict of them, nested) as the graph group's rank 0
    holds it, on every rank, on the mesh's device: a broadcast."""
    if isinstance(x, Mapping):
        return {k: replicate(mesh, v, axis) for k, v in x.items()}
    group, _, size = axis_group(mesh, axis)
    t = torch.as_tensor(x).to(mesh_device(mesh)).contiguous().clone()
    if size > 1:
        staged_collective(dist.broadcast, t, group, src=dist.get_global_rank(group, 0))
    return t


class _Ring:
    """One halo exchange's P-1 ring steps, posted and in flight.

    Forward: step d sends ``x[send_idx[d - 1]]`` to (r+d)%P and receives
    K_d rows from (r-d)%P into the buffer at ``halo_offsets[d]``. Reversed
    (the backward): step d sends the buffer's cotangent rows at
    ``halo_offsets[d]`` back to (r-d)%P and receives, from (r+d)%P, the
    cotangents of the rows it sent there at step d."""

    def __init__(self, group, rank: int, size: int, dg: DistGraph, send_idx, x: torch.Tensor, reverse: bool):
        self.dg, self.send_idx, self.reverse = dg, send_idx, reverse
        dev = x.device
        staged = host_staged(group, dev)
        width = tuple(x.shape[1:])
        ops, self.copies, self.recvs, self.keep = [], [], [], []
        if reverse:
            self.out = torch.zeros((dg.nodes_per_shard,) + width, dtype=x.dtype, device=dev)
        else:
            self.out = torch.zeros((dg.halo_total,) + width, dtype=x.dtype, device=dev)
        for d in range(1, size):
            k, off = int(dg.send_idx_by_d[d - 1].shape[1]), int(dg.halo_offsets[d])
            if reverse:
                send, to, frm = x[off : off + k], (rank - d) % size, (rank + d) % size
                recv = torch.empty((k,) + width, dtype=x.dtype, device=dev)
            else:
                send, to, frm = x[send_idx[d - 1]], (rank + d) % size, (rank - d) % size
                recv = self.out[off : off + k]
            if staged:
                send = send.cpu()
                host = torch.empty(recv.shape, dtype=recv.dtype)
                self.copies.append((recv, host))
                recv_buf = host
            else:
                send, recv_buf = send.contiguous(), recv
            self.keep.append(send)
            self.recvs.append((d, recv))
            ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group))
            ops.append(dist.P2POp(dist.irecv, recv_buf, dist.get_global_rank(group, frm), group))
            exchange.rows += k
            exchange.bytes += send.numel() * send.element_size()
        self.works = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> torch.Tensor:
        """Wait for the steps; the received buffer (forward) or the gradient
        of the sent rows (reversed)."""
        for work in self.works:
            work.wait()
        for dev_buf, host in self.copies:
            dev_buf.copy_(host)
        if self.reverse:
            for d, recv in self.recvs:
                self.out.index_add_(0, self.send_idx[d - 1], recv)
        self.works, self.copies, self.keep = [], [], []
        return self.out


def exchange(mesh, dg: DistGraph, x: torch.Tensor, axis: str = "graph"):
    """Post the halo exchange of this rank's rows ``x`` (Ns, ...) and return
    ``finish``: called later, it waits and returns the (halo_total, ...)
    received buffer, differentiable in ``x``. Work issued between the two
    calls overlaps the exchange. ``exchange.rows`` and ``exchange.bytes``
    count the rows and bytes this rank has sent, forward and backward."""
    group, r, p = _axis(mesh, dg, axis)
    if p == 1:
        zeros = x.new_zeros((dg.halo_total,) + tuple(x.shape[1:]))
        return lambda: zeros
    shard = dg.shard(r, x.device)
    ring = _Ring(group, r, p, dg, shard.send_idx, x.detach(), reverse=False)
    return lambda: _HaloExchange.apply(x, ring, group, r, p)


exchange.rows = 0  # halo rows sent since the counts were last reset
exchange.bytes = 0


class _HaloExchange(torch.autograd.Function):
    """The received halo buffer of a posted ring; its backward is the
    reversed ring and the scatter-add JAX synthesises."""

    @staticmethod
    def forward(ctx, x, ring, group, rank, size):
        ctx.ring_args = (group, rank, size, ring.dg, ring.send_idx)
        return ring.wait()

    @staticmethod
    def backward(ctx, g):
        group, rank, size, dg, send_idx = ctx.ring_args
        return _Ring(group, rank, size, dg, send_idx, g.contiguous(), reverse=True).wait(), None, None, None, None


def _reduce(csr, table: torch.Tensor, w: Optional[torch.Tensor], heads: int, impl: str):
    """``sum_e w[e] * table[col_e]`` into ``csr``'s rows, as (rows, heads *
    F); None for a CSR with no edges."""
    if csr.num_edges == 0:
        return None
    if impl == "kernel":
        w_arg = None if w is None else (w.reshape(-1) if heads == 1 else w)
        return spmm_traced(csr, table, w_arg, heads)
    # plain torch: gather, weigh, masked segment sum (not ``ops.message``,
    # whose ``aggregate`` sends large sums on the card to the kernels)
    msg = table[csr.cols_clamped.long()]
    if w is not None:
        msg = (msg.reshape(csr.capacity, heads, -1) * w.reshape(csr.capacity, heads, 1)).reshape(csr.capacity, -1)
    return seg.segment_sum(msg, csr.rows, csr.num_nodes, edge_mask=csr.edge_mask)


def _sum(parts: List[Optional[torch.Tensor]], like: torch.Tensor, rows: int) -> torch.Tensor:
    parts = [t for t in parts if t is not None]
    if not parts:
        return like.new_zeros(rows, like.shape[1])
    return parts[0] if len(parts) == 1 else parts[0] + parts[1]


def _route(w_local: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Local-slot-order weights (cap, heads) in a split's slot order (pos:
    the local slot of each split slot, the local capacity on padding)."""
    cap = w_local.shape[0]
    valid = (pos < cap)[:, None]
    return torch.where(valid, w_local[pos.clamp(max=cap - 1)], torch.zeros((), dtype=w_local.dtype,
                                                                            device=w_local.device))


def _check_tiling(heads: int, f: int, what: str) -> None:
    if heads > 1 and (128 % f != 0 or (heads * f) % 128 != 0):
        raise ValueError(f"{what} with impl='kernel' needs 128 % F == 0 and heads*F % 128 == 0, "
                         f"got heads={heads}, F={f}")


def dist_spmm(
    mesh,
    dg: DistGraph,
    h: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    axis: str = "graph",
    overlap: bool = True,
    impl: str = "torch",
) -> torch.Tensor:
    """``out[d] = sum over in-edges of w_e · h[src]``, edge-partitioned.

    ``h`` is this rank's (Ns, F) shard (``shard_node_array``); the result
    is too. ``edge_weight`` is optional per-edge data in this shard's local
    slot order, (cap,) or (cap, H) (``shard_edge_array(..., 'local')``); with
    (cap, H) weights ``h`` is (Ns, H, F) and so is the result.

    ``overlap=True`` reduces the interior edges while the halo is in
    flight, then the frontier edges over the received buffer; ``False``
    runs one reduction over the widened ``[local | halo]`` buffer and the
    local CSR. As in the JAX package, the plain route's weighted sum always
    takes the widened reduction; the kernel route with weights routes them
    into interior and frontier order (``interior_pos``/``frontier_pos``).

    ``impl='kernel'`` runs the reductions on K1's shard mode (f32 stream
    unless ``h`` is bf16); several heads need ``128 % F == 0`` and
    ``(H·F) % 128 == 0`` (``ValueError``), as JAX's Pallas route.
    ``'torch'`` is the plain route.
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown dist_spmm impl {impl!r}")
    _, r, _ = _axis(mesh, dg, axis)
    ns = dg.nodes_per_shard
    if h.shape[0] != ns:
        raise ValueError(f"h must be this rank's shard of {ns} rows, got {tuple(h.shape)}")
    weighted = edge_weight is not None
    multihead = weighted and h.dim() == 3
    heads, f = (h.shape[1], h.shape[2]) if multihead else (1, h.shape[-1])
    if impl == "kernel":
        _check_tiling(heads, f, "multihead dist_spmm")
    shard = dg.shard(r, h.device)
    h2 = h.reshape(ns, heads * f) if multihead else h
    w_local = edge_weight.reshape(edge_weight.shape[0], -1) if weighted else None
    finish = exchange(mesh, dg, h2, axis)
    if overlap and (impl == "kernel" or not weighted):
        w_int = _route(w_local, shard.interior_pos) if weighted else None
        w_fro = _route(w_local, shard.frontier_pos) if weighted else None
        interior = _reduce(shard.interior_csr, h2, w_int, heads, impl)  # while the ring is in flight
        recv = finish()
        out = _sum([interior, _reduce(shard.frontier_csr, recv, w_fro, heads, impl)], h2, ns)
    else:
        buf = torch.cat([h2, finish()], dim=0)
        out = _sum([_reduce(shard.local_csr, buf, w_local, heads, impl)], h2, ns)
    return out.reshape(ns, heads, f) if multihead else out


def dist_gat_attention(
    mesh,
    dg: DistGraph,
    el: torch.Tensor,
    er: torch.Tensor,
    feat_src: torch.Tensor,
    negative_slope: float = 0.2,
    axis: str = "graph",
    impl: str = "torch",
) -> torch.Tensor:
    """Edge-partitioned GAT attention: one fused halo exchange, then a
    shard-local segment softmax and weighted aggregation.

    ``el`` and ``er`` are this rank's (Ns, H) source and destination scores
    and ``feat_src`` its (Ns, H, F) features; returns (Ns, H, F). Shards own
    destination ranges, so every node's in-neighbourhood lives on one shard
    and the only communication is the ``[feat_src | el]`` halo. The scores,
    the stability max and the denominator stay plain torch, as the JAX
    package keeps them in ``jnp`` on its kernel route; ``impl='kernel'``
    runs the (E, H·F) aggregation, the wide reduction, on K1's shard mode
    in its heads mode (``128 % F == 0`` and ``(H·F) % 128 == 0`` for
    several heads).
    """
    if impl not in _IMPLS:
        raise ValueError(f"unknown dist_gat_attention impl {impl!r}")
    _, r, _ = _axis(mesh, dg, axis)
    ns = dg.nodes_per_shard
    h, f = el.shape[-1], feat_src.shape[-1]
    if impl == "kernel":
        _check_tiling(h, f, "dist GAT")
    csr = dg.shard(r, el.device).local_csr
    fs2 = feat_src.reshape(ns, h * f)
    recv = exchange(mesh, dg, torch.cat([fs2, el], dim=1), axis)()
    fs_wide = torch.cat([fs2, recv[:, : h * f]], dim=0)
    el_wide = torch.cat([el, recv[:, h * f :]], dim=0)

    rows_c = csr.rows_clamped.long()
    emask = csr.edge_mask
    s = el_wide[csr.cols.long()] + er[rows_c]  # padding cols are 0: in range
    s = torch.where(s >= 0, s, negative_slope * s)
    m = seg.segment_max(s, csr.rows, ns, edge_mask=emask)
    w = torch.exp(s - m[rows_c]) * emask[:, None]
    denom = seg.segment_sum(w, csr.rows, ns, edge_mask=emask).clamp(min=torch.finfo(torch.float32).tiny)
    if impl == "kernel":
        u = _sum([_reduce(csr, fs_wide, w, h, impl)], fs2, ns)
    else:
        msg = fs_wide[csr.cols.long()].reshape(-1, h, f) * w[..., None]
        u = seg.segment_sum(msg.reshape(-1, h * f), csr.rows, ns, edge_mask=emask)
    return u.reshape(ns, h, f) / denom[:, :, None]
