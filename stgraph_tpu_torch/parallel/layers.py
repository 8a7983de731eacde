"""Distributed layer functions: GCN conv, GAT conv and TGCN cell over a mesh.

Counterpart of ``stgraph_tpu/parallel/layers.py``: functional building
blocks for edge-partitioned training. Parameters are replicated dicts of
tensors, node arrays are this rank's shard (destination range), and
aggregation is the halo-exchange ``dist_spmm`` / ``dist_gat_attention``.
The ``*_params`` draw from an explicit ``torch.Generator`` (the JAX ones
from a key); ``convert.dist_*_params_from_jax`` carries the JAX package's
parameters over, so that both compute the same thing.

JAX sums a replicated parameter's gradient over the mesh when it
transposes the ``shard_map``; here each rank's autograd sees only its
shard, so the caller sums them with ``reduce_replicated_grads`` (one
``all_reduce``) after ``backward``. A loss that is a mean over the P·Ns
padded rows is each rank's sum over its Ns rows divided by P·Ns.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

from stgraph_tpu_torch.parallel.halo import dist_gat_attention, dist_spmm
from stgraph_tpu_torch.parallel.mesh import axis_group, staged_collective
from stgraph_tpu_torch.parallel.partition import DistGraph
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = [
    "dist_gat_conv",
    "dist_gat_params",
    "dist_gcn_conv",
    "dist_gcn_params",
    "dist_tgcn_cell",
    "dist_tgcn_params",
    "reduce_replicated_grads",
]


def _uniform(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """U(-scale, scale) drawn on the generator's device, moved to ``device``."""
    u = torch.rand(shape, generator=gen, dtype=dtype, device=gen.device)
    return ((u * 2 - 1) * scale).to(device)


def dist_gcn_params(gen: torch.Generator, in_feats: int, out_feats: int, dtype=torch.float32, device=None) -> Dict:
    """Xavier-uniform replicated GCN parameters (zero bias) on ``device``
    (default ``cuda``; the draws come from ``gen`` on its own device)."""
    device = resolve_device(device)
    scale = (6.0 / (in_feats + out_feats)) ** 0.5
    return {"weight": _uniform(gen, (in_feats, out_feats), scale, dtype, device),
            "bias": torch.zeros(out_feats, dtype=dtype, device=device)}


def dist_gcn_conv(
    mesh,
    dg: DistGraph,
    params: Mapping,
    h: torch.Tensor,
    norm: torch.Tensor,
    activation=None,
    impl: str = "torch",
) -> torch.Tensor:
    """One GCN layer, ``act(norm · A · norm · (h W) + b)``, on this rank's
    shard: the projection is local, the aggregation the overlapped
    halo-exchange SpMM (``impl`` as for ``dist_spmm``)."""
    h = h @ params["weight"]
    h = dist_spmm(mesh, dg, h * norm, impl=impl) * norm
    h = h + params["bias"]
    return activation(h) if activation is not None else h


def dist_gat_params(
    gen: torch.Generator, in_feats: int, out_feats: int, num_heads: int, dtype=torch.float32, device=None
) -> Dict:
    """Xavier-uniform replicated GAT parameters (mirrors ``nn.GATConv``):
    ``fc`` (in, H·F), ``attn_l``/``attn_r`` (H, F), zero ``bias`` (H·F,), on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    scale = (6.0 / (in_feats + num_heads * out_feats)) ** 0.5
    a_scale = (6.0 / (out_feats + 1)) ** 0.5
    return {
        "fc": _uniform(gen, (in_feats, num_heads * out_feats), scale, dtype, device),
        "attn_l": _uniform(gen, (num_heads, out_feats), a_scale, dtype, device),
        "attn_r": _uniform(gen, (num_heads, out_feats), a_scale, dtype, device),
        "bias": torch.zeros(num_heads * out_feats, dtype=dtype, device=device),
    }


def dist_gat_conv(
    mesh,
    dg: DistGraph,
    params: Mapping,
    h: torch.Tensor,
    negative_slope: float = 0.2,
    activation=None,
    impl: str = "torch",
) -> torch.Tensor:
    """One GAT layer on this rank's shard: the projection and scores, one
    fused halo exchange of ``[features | el]``, the shard-local softmax and
    aggregation (``dist_gat_attention``). Returns (Ns, H, F)."""
    heads, out_feats = params["attn_l"].shape
    fs = (h @ params["fc"]).reshape(h.shape[0], heads, out_feats)
    el = (fs * params["attn_l"][None]).sum(-1)
    er = (fs * params["attn_r"][None]).sum(-1)
    out = dist_gat_attention(mesh, dg, el, er, fs, negative_slope=negative_slope, impl=impl)
    out = out + params["bias"].reshape(1, heads, out_feats)
    return activation(out) if activation is not None else out


def dist_tgcn_params(gen: torch.Generator, in_feats: int, out_feats: int, dtype=torch.float32, device=None) -> Dict:
    """The three GCN gates and the three gate linears of a TGCN cell, on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    p = {}
    for gate in "zrh":
        p[f"conv_{gate}"] = dist_gcn_params(gen, in_feats, out_feats, dtype, device)
    scale = (6.0 / (3 * out_feats)) ** 0.5
    for gate in "zrh":
        # the gate linear over [conv_out | hidden], as nn.TGCN's
        p[f"lin_{gate}"] = {"weight": _uniform(gen, (2 * out_feats, out_feats), scale, dtype, device),
                            "bias": torch.zeros(out_feats, dtype=dtype, device=device)}
    return p


def dist_tgcn_cell(
    mesh,
    dg: DistGraph,
    params: Mapping,
    x: torch.Tensor,
    norm: torch.Tensor,
    hidden: Optional[torch.Tensor] = None,
    impl: str = "torch",
) -> torch.Tensor:
    """One TGCN (GRU of GCNs) step on this rank's shard; mirrors ``nn.TGCN``."""
    out_feats = params["conv_z"]["weight"].shape[1]
    if hidden is None:
        hidden = x.new_zeros(x.shape[0], out_feats)

    def gate(name, inp, hid):
        g = dist_gcn_conv(mesh, dg, params[f"conv_{name}"], inp, norm, impl=impl)
        g = g.clamp(-1e6, 1e6)  # nn.TGCN's clamp guard
        lin = params[f"lin_{name}"]
        return torch.cat([g, hid], dim=1) @ lin["weight"] + lin["bias"]

    z = torch.sigmoid(gate("z", x, hidden))
    r = torch.sigmoid(gate("r", x, hidden))
    h_tilde = torch.tanh(gate("h", x, hidden * r))
    return z * hidden + (1.0 - z) * h_tilde


def _leaves(params) -> Iterable[torch.Tensor]:
    if isinstance(params, Mapping):
        for v in params.values():
            yield from _leaves(v)
    elif isinstance(params, torch.Tensor):
        yield params
    else:
        for v in params:
            yield from _leaves(v)


def reduce_replicated_grads(mesh, params, axis: str = "graph") -> None:
    """Sum the gradients of replicated parameters over the mesh's ``axis``
    group, in place, with one ``all_reduce`` of their concatenation.

    ``params`` is a tensor, a (nested) dict or a sequence of them; those
    without a gradient are skipped. After it every rank holds the gradient
    of the whole loss, as ``jax.grad`` gives it."""
    group, _, size = axis_group(mesh, axis)
    leaves = [t for t in _leaves(params) if t.grad is not None]
    if size == 1 or not leaves:
        return
    flat = staged_collective(dist.all_reduce, torch.cat([t.grad.reshape(-1) for t in leaves]), group)
    i = 0
    for t in leaves:
        t.grad.copy_(flat[i : i + t.numel()].reshape(t.shape))
        i += t.numel()
