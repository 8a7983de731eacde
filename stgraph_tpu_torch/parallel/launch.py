"""Multi-process initialization on ``torch.distributed``.

Counterpart of ``stgraph_tpu/parallel/launch.py``. Where JAX's
``jax.distributed.initialize`` joins the hosts of a pod slice, this joins
the processes of a job into one default process group, over a ``tcp://``
rendezvous: NCCL when the card is there, gloo on the CPU (or when asked,
as for two processes that share one card).

Usage (the same script started once per process)::

    from stgraph_tpu_torch.parallel import launch
    launch.initialize("10.0.0.1:29500", num_processes=4, process_id=rank)
    mesh = make_mesh()               # spans the 4 processes

With no arguments it reads ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK`` (what ``torchrun`` sets); with neither arguments nor variables it
does nothing, as a single-process run needs no group.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multihost", "process_info", "shutdown"]


def _config(coordinator_address, num_processes, process_id):
    """The explicit configuration, from the arguments or the environment;
    None when neither gives any part of one."""
    env = os.environ
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '')}"
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if addr is None and world is None and rank is None:
        return None
    if addr is None or world is None or rank is None:
        raise ValueError(
            "a process group needs the coordinator address, the number of processes and this "
            f"process's id; got {addr!r}, {world!r}, {rank!r}"
        )
    host, _, port = str(addr).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address must be host:port, got {addr!r}")
    world, rank = int(world), int(rank)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"process id {rank} is outside a group of {world}")
    return f"tcp://{host}:{port}", world, rank


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """``torch.distributed.init_process_group`` from an explicit
    configuration (idempotent).

    ``coordinator_address`` is ``host:port`` of the rendezvous (rank 0
    serves it). ``backend`` defaults to ``nccl`` when CUDA is available and
    ``gloo`` otherwise. An explicit configuration that is incomplete or
    fails raises (the group is not half made, so a corrected retry works);
    with no configuration at all this does nothing.
    """
    if dist.is_initialized():
        return
    cfg = _config(coordinator_address, num_processes, process_id)
    if cfg is None:
        return  # a single process: no group, as JAX's single-host no-op
    init_method, world, rank = cfg
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    """Whether this process is one of several in a group."""
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> dict:
    """JAX's keys: this process's index and the process count, the devices
    this process drives and the devices of the whole group (one each)."""
    grouped = dist.is_initialized()
    count = dist.get_world_size() if grouped else 1
    return {
        "process_index": dist.get_rank() if grouped else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }
