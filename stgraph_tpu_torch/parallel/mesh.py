"""Device-mesh helpers.

Counterpart of ``stgraph_tpu/parallel/mesh.py``: a ``('data', 'graph')``
mesh, the ``graph`` axis for edge-partitioned message passing and ``data``
for batch or snapshot parallelism. Here it is a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
default group, one device each.

``manual_shard_map`` has no counterpart. Torch's ranks already run one
program each (SPMD), so every function of the distribution layer is
written for one rank's shard, and the collectives are explicit. Its bypass
mode exists for ``parallel/batch.py``'s flat JAX region, which has no
torch equivalent to bypass.

Gloo moves no CUDA tensor, so a collective over a gloo group (two
processes that share one card run so) copies a CUDA tensor to the host and
back, by backend (``host_staged``, ``staged_collective``); NCCL moves the
device tensors themselves.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["axis_group", "host_staged", "make_mesh", "mesh_device", "staged_collective"]


def make_mesh(graph: Optional[int] = None, data: int = 1, device=None) -> DeviceMesh:
    """A ``('data', 'graph')`` mesh over the default process group.

    ``graph`` defaults to the group's size divided by ``data``; the mesh
    must cover the group (``ValueError`` otherwise). ``device`` is the
    device type of the mesh (default ``cuda``). On CUDA each process drives
    the card ``device``'s index names, or its rank modulo the cards it
    sees; two processes may share one card. Call
    ``parallel.launch.initialize`` first.
    """
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call stgraph_tpu_torch.parallel.launch.initialize() first")
    world = dist.get_world_size()
    if graph is None:
        graph = world // data
    if data * graph != world:
        raise ValueError(f"a {data} x {graph} mesh needs {data * graph} processes, the group has {world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None else dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, (data, graph), mesh_dim_names=("data", "graph"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process drives in ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_group(mesh: DeviceMesh, axis: str = "graph") -> Tuple[dist.ProcessGroup, int, int]:
    """(process group, this rank's index in it, its size) of a mesh axis."""
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def host_staged(group: Optional[dist.ProcessGroup], device: torch.device) -> bool:
    """Whether a tensor on ``device`` crosses ``group`` (None: the default
    group) through the host: gloo moves no CUDA tensor."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def staged_collective(op: Callable, t: torch.Tensor, group: Optional[dist.ProcessGroup], **kwargs) -> torch.Tensor:
    """Run the in-place collective ``op`` (``dist.all_reduce``,
    ``dist.broadcast``, ...) on ``t`` over ``group``, through a host copy
    where ``host_staged``; returns ``t``, updated."""
    if not host_staged(group, t.device):
        op(t, group=group, **kwargs)
        return t
    host = t.cpu()
    op(host, group=group, **kwargs)
    return t.copy_(host)
