"""Window-parallel temporal training on a 2-D ('data', 'graph') mesh.

Counterpart of ``stgraph_tpu/parallel/batch.py``: TGCN's BPTT windows are
data-parallel (each window threads its own hidden state through time), so
the windows split over the mesh's ``data`` groups while each group keeps the
graph edge-partitioned over its ``graph`` ranks, through ``dist_tgcn_cell``
(K1's shard mode on the kernel route).

Where JAX runs one flat ``shard_map`` manual over both axes, each rank here
runs its own windows on its own shard: ``shard_window_batch`` gives the
rank's (B/D, T, Ns, F) slice. The loss sums each timestep's masked squared
error over the ``graph`` group and averages over timesteps, windows and the
``data`` group, as JAX's ``psum`` and ``pmean`` do.

Gradients. JAX's transpose of the flat region sums the replicated
parameters' cotangents over both axes. Here the parameters enter the loss
through an identity whose backward sums their gradients with one
``all_reduce`` over the ``graph`` group, then one over the ``data`` group
(each rank's share of the loss is already divided by the data size), and
the loss value is summed over both groups in the forward, with an identity
backward. So after ``loss.backward()`` every rank holds the batch-mean
gradient of the global loss, the same on every rank, as ``jax.grad`` gives
it; no ``reduce_replicated_grads`` follows.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.distributed as dist

from stgraph_tpu_torch.parallel.halo import _axis
from stgraph_tpu_torch.parallel.layers import _leaves, dist_tgcn_cell
from stgraph_tpu_torch.parallel.mesh import axis_group, mesh_device, staged_collective
from stgraph_tpu_torch.parallel.partition import DistGraph

__all__ = ["dist_tgcn_batched_loss", "shard_window_batch"]


def shard_window_batch(mesh, xs, dg: DistGraph, data_axis: str = "data") -> torch.Tensor:
    """This rank's slice of a (B, T, N, F) window batch on the mesh's
    device: windows ``[d·B/D, (d+1)·B/D)`` of its ``data`` index d, node rows
    ``[r·Ns, (r+1)·Ns)`` of its ``graph`` index r, zero-padded to Ns.
    ``ValueError`` when D does not divide B."""
    _, d, size = axis_group(mesh, data_axis)
    _, r, _ = _axis(mesh, dg, "graph")
    xs = torch.as_tensor(xs)
    b, n = xs.shape[0], xs.shape[2]
    if b % size:
        raise ValueError(f"window batch {b} not divisible by {data_axis}={size}")
    per, ns = b // size, dg.nodes_per_shard
    lo, hi = min(r * ns, n), min((r + 1) * ns, n)
    part = xs[d * per:(d + 1) * per, :, lo:hi]
    if hi - lo < ns:
        part = torch.cat([part, part.new_zeros(part.shape[:2] + (ns - (hi - lo),) + part.shape[3:])], dim=2)
    return part.to(mesh_device(mesh))


def _mesh_sum(t: torch.Tensor, groups) -> torch.Tensor:
    for group, size in groups:
        if size > 1:
            staged_collective(dist.all_reduce, t, group)
    return t


class _MeshSum(torch.autograd.Function):
    """The loss summed over the mesh; each rank's gradient of its share is 1."""

    @staticmethod
    def forward(ctx, local, groups):
        return _mesh_sum(local.detach().clone(), groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Replicated(torch.autograd.Function):
    """Identity on the parameters; the backward sums their gradients over the
    mesh in one concatenated ``all_reduce`` a group."""

    @staticmethod
    def forward(ctx, groups, *leaves):
        ctx.groups, ctx.device = groups, leaves[0].device
        ctx.shapes = [leaf.shape for leaf in leaves]
        return tuple(leaf.clone() for leaf in leaves)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([(g if g is not None else torch.zeros(s, device=ctx.device)).reshape(-1)
                          for g, s in zip(grads, ctx.shapes)])
        flat = _mesh_sum(flat, ctx.groups)
        out, i = [], 0
        for s in ctx.shapes:
            k = s.numel()
            out.append(flat[i:i + k].reshape(s))
            i += k
        return (None, *out)


def _rebuild(params, leaves):
    """``params``' nesting with its leaves (in ``_leaves`` order) replaced."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return next(it)

    return walk(params)


def dist_tgcn_batched_loss(
    mesh,
    dg: DistGraph,
    params: Dict,
    norm: torch.Tensor,  # (Ns, 1) this rank's rows
    xs_b: torch.Tensor,  # (B/D, T, Ns, F) this rank's slice (shard_window_batch)
    ys_b: torch.Tensor,  # (B/D, T, Ns, F_out)
    data_axis: str = "data",
) -> torch.Tensor:
    """Mean MSE of TGCN regression over a batch of BPTT windows, the same
    scalar on every rank.

    Each window runs its own hidden state from zero through its T
    timesteps; a timestep's loss is the squared error over the real rows
    (index below ``dg.num_nodes``: TGCN's GRU biases make padding rows'
    hidden states nonzero) summed over the ``graph`` group and divided by
    ``num_nodes · out_feats``; the loss is its mean over the timesteps, the
    windows and the ``data`` group. Each cell is ``dist_tgcn_cell``'s
    ``'kernel'`` path (K1's shard mode). ``ValueError`` unless every rank of the
    ``data`` group holds as many windows (a batch that does not divide).
    Differentiable in ``params``: see the module's docstring."""
    d_group, _, d_size = axis_group(mesh, data_axis)
    g_group, g_rank, g_size = _axis(mesh, dg, "graph")
    groups = ((g_group, g_size), (d_group, d_size))
    b_local = xs_b.shape[0]
    if d_size > 1:  # the data group's ranks hold equal shares
        share = torch.tensor([b_local, -b_local], device=xs_b.device)
        staged_collective(lambda t, group: dist.all_reduce(t, dist.ReduceOp.MAX, group), share, d_group)
        if int(share[0]) != -int(share[1]):
            raise ValueError(f"window batch not divisible by {data_axis}={d_size}: ranks hold "
                             f"{-int(share[1])} to {int(share[0])} windows")
    if b_local == 0:
        raise ValueError("an empty window batch")
    out_feats = params["conv_z"]["weight"].shape[1]
    ns, n_real = dg.nodes_per_shard, dg.num_nodes
    leaves = list(_leaves(params))
    if any(leaf.requires_grad for leaf in leaves):
        replicated = _Replicated.apply(groups, *leaves)
        params = _rebuild(params, (replicated,) if torch.is_tensor(replicated) else replicated)
    mask = (g_rank * ns + torch.arange(ns, device=xs_b.device) < n_real)[:, None]
    windows = []
    for i in range(b_local):
        hidden = xs_b.new_zeros(ns, out_feats)
        losses = []
        for t in range(xs_b.shape[1]):
            hidden = dist_tgcn_cell(mesh, dg, params, xs_b[i, t], norm, hidden, impl="kernel")
            err = torch.where(mask, (hidden - ys_b[i, t]) ** 2, 0.0)
            losses.append(err.sum() / (n_real * out_feats))
        windows.append(torch.stack(losses).mean())
    local = torch.stack(windows).mean() / d_size
    return _MeshSum.apply(local, groups)
