"""Profiling and timing utilities.

Counterpart of ``stgraph_tpu/utils/profiler.py``:

* ``Timer``: named wall-clock accumulators; the device work of the
  tensors handed to the holder is drained (``torch.cuda.synchronize``)
  before the clock stops, so asynchronous launches do not flatter the
  number;
* ``trace``: a context manager around ``torch.profiler.profile`` (CPU
  activity, and CUDA activity where a card is present) that writes a
  Chrome trace into a directory;
* ``device_memory_stats``: live and peak device bytes and the card's
  memory, per CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["Timer", "device_memory_stats", "trace"]


class Timer:
    """Named accumulating wall-clock timers.

    ``with timer.time("fwd") as sync: out = f(); sync.value = out`` adds to
    the "fwd" bucket; the CUDA devices of the tensors in ``sync.value`` (a
    tensor, or a list, tuple or dict of them) are synchronised before the
    clock stops.
    """

    def __init__(self) -> None:
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        holder = _SyncHolder()
        try:
            yield holder
        finally:
            for dev in _cuda_devices(holder.value):
                torch.cuda.synchronize(dev)
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def total(self, name: str) -> float:
        return self._total[name]

    def mean(self, name: str) -> float:
        c = self._count[name]
        return self._total[name] / c if c else 0.0

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self._total[k], "count": self._count[k], "mean_s": self.mean(k)}
            for k in sorted(self._total)
        }

    def reset(self) -> None:
        self._total.clear()
        self._count.clear()


class _SyncHolder:
    """Mutable cell: set ``.value`` to the tensors to drain before stop."""

    value = None


def _cuda_devices(value) -> set:
    if torch.is_tensor(value):
        return {value.device} if value.device.type == "cuda" else set()
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (list, tuple)):
        return set().union(*(_cuda_devices(v) for v in value)) if value else set()
    return set()


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the enclosed block with ``torch.profiler`` when a logdir is
    given, and write its Chrome trace there (``trace-<pid>-<ns>.json``);
    yields the profiler. A no-op with ``logdir=None``. A profiler that fails
    to start raises (JAX's version carries on without a trace)."""
    if logdir is None:
        yield None
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def device_memory_stats(device=None) -> Dict[str, Dict[str, int]]:
    """``{device: {bytes_in_use, peak_bytes_in_use, bytes_limit}}``: the
    caching allocator's live and peak bytes and the card's memory, for
    ``device`` or, without one, every visible CUDA device (raises when CUDA
    is absent). ``device="cpu"`` gives zeros, as JAX's CPU backend does."""
    if device is not None and torch.device(device).type == "cpu":
        return {"cpu": {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}}
    devs = ([resolve_device(device)] if device is not None
            else [resolve_device(f"cuda:{i}") for i in range(max(torch.cuda.device_count(), 1))])
    return {
        str(d): {
            "bytes_in_use": int(torch.cuda.memory_allocated(d)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(d)),
            "bytes_limit": int(torch.cuda.get_device_properties(d).total_memory),
        }
        for d in devs
    }
