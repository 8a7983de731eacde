"""The port's utilities against the JAX package's contracts
(``stgraph_tpu/utils/{profiler,device_info,cache,fetch}.py``): ``Timer``'s
buckets and its holder's synchronisation, ``trace``, ``device_memory_stats``
and ``DeviceInfo`` on the CPU and without CUDA, ``device_fetch`` and
``fetch_float`` round trips and their timeout latch, and
``setup_compilation_cache`` moving the kernel libraries' paths.

The latch is process-wide, and xdist runs other tests in the same worker:
the tests that set it restore it.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from stgraph_tpu.utils import __all__ as jax_utils_all
from stgraph_tpu_torch import utils
from stgraph_tpu_torch.ops import kernel_lib
from stgraph_tpu_torch.utils import build, cache, device_info, fetch, profiler
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_utils_exports_the_jax_names_and_resolve_device():
    assert sorted(utils.__all__) == sorted(jax_utils_all + ["resolve_device"])
    for name in utils.__all__:
        assert hasattr(utils, name), name


def test_timer_totals_means_and_summary(monkeypatch):
    clock = iter([0.0, 1.5, 10.0, 10.5, 20.0, 22.0])
    monkeypatch.setattr(profiler.time, "perf_counter", lambda: next(clock))
    t = profiler.Timer()
    for name in ("fwd", "bwd", "fwd"):
        with t.time(name):
            pass
    assert t.total("fwd") == 3.5 and t.mean("fwd") == 1.75 and t.total("bwd") == 0.5
    assert t.mean("never") == 0.0
    assert t.summary() == {"bwd": {"total_s": 0.5, "count": 1, "mean_s": 0.5},
                           "fwd": {"total_s": 3.5, "count": 2, "mean_s": 1.75}}
    t.reset()
    assert t.summary() == {}


def test_timer_synchronises_the_holders_cuda_devices_before_the_clock_stops(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(str(dev)))
    t = profiler.Timer()
    with t.time("cpu") as sync:
        sync.value = torch.ones(3)
    assert synced == []  # a CPU tensor has nothing to drain
    with t.time("cuda") as sync:
        sync.value = {"a": torch.empty(2, device="meta"), "b": [torch.ones(1)]}
    assert synced == []
    assert profiler._cuda_devices([torch.ones(1), (torch.ones(1),)]) == set()
    monkeypatch.setattr(profiler, "_cuda_devices", lambda v: {torch.device("cuda", 1)} if v is not None else set())
    with t.time("cuda") as sync:
        sync.value = torch.ones(1)
    assert synced == ["cuda:1"] and t.summary()["cuda"]["count"] == 2


def test_trace_without_a_logdir_does_nothing_and_with_one_writes_a_trace(tmp_path):
    with profiler.trace(None) as prof:
        assert prof is None
    logdir = tmp_path / "tb"
    with profiler.trace(str(logdir)) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert prof is not None
    (written,) = os.listdir(logdir)
    assert written.startswith(f"trace-{os.getpid()}-") and (logdir / written).stat().st_size > 0


def test_device_memory_stats_on_the_cpu_and_without_cuda(monkeypatch):
    assert profiler.device_memory_stats(device="cpu") == {
        "cpu": {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profiler.device_memory_stats()


def test_device_info_lists_the_cpu_and_raises_without_cuda(monkeypatch, capsys):
    info = utils.DeviceInfo(device="cpu")
    assert info.backend == "cpu"
    assert info.rows() == [{"id": "0", "platform": "cpu", "kind": "cpu", "process": "0", "hbm_limit_gb": "0.0",
                            "hbm_in_use_mb": "0.0"}]
    info.log()
    out = capsys.readouterr().out
    assert "torch devices (backend=cpu)" in out and "hbm_limit_gb" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_info.DeviceInfo()


@pytest.fixture
def latch():
    """The module's process-wide flag, restored after the test."""
    before = fetch._broken
    yield
    fetch._broken = before


def test_device_fetch_and_fetch_float_round_trips(latch):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    assert fetch.device_fetch(x) is x  # numpy passes through
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    np.testing.assert_array_equal(fetch.device_fetch(t * 1), x)
    np.testing.assert_array_equal(fetch.device_fetch(torch.tensor([1.5, 2.5], dtype=torch.bfloat16)), [1.5, 2.5])
    assert fetch.fetch_float(torch.tensor(2.25)) == 2.25 and fetch.fetch_float(3) == 3.0
    assert fetch.d2h_available()


def test_a_fetch_that_times_out_latches_the_flag(latch, monkeypatch):
    release = threading.Event()

    def slow(x):
        release.wait(5.0)
        return np.asarray(0.0)

    monkeypatch.setattr(fetch, "_to_numpy", slow)
    t0 = time.perf_counter()
    assert fetch.device_fetch(torch.ones(1), timeout_s=0.05) is None
    assert time.perf_counter() - t0 < 2.0
    release.set()
    assert not fetch.d2h_available()
    monkeypatch.undo()  # a fast copy again: the latch still answers
    assert fetch.device_fetch(torch.ones(1)) is None
    assert np.isnan(fetch.fetch_float(torch.ones(())))


def test_a_failing_copy_raises_in_the_caller(latch, monkeypatch):
    def broken(x):
        raise TypeError("cannot copy")

    monkeypatch.setattr(fetch, "_to_numpy", broken)
    with pytest.raises(TypeError, match="cannot copy"):
        fetch.device_fetch(torch.ones(1))
    assert fetch.d2h_available()


@pytest.fixture
def build_root():
    before = build._root
    yield
    build.set_build_root(before)


def test_setup_compilation_cache_moves_the_libraries(build_root, tmp_path, monkeypatch):
    monkeypatch.delenv("STGRAPH_TPU_CACHE_DIR", raising=False)
    default = kernel_lib._paths(["spmm_rowmask"])["spmm_rowmask"]
    cache.setup_compilation_cache()  # neither a path nor the variable: the default stays
    assert kernel_lib._paths(["spmm_rowmask"])["spmm_rowmask"] == default
    assert os.path.dirname(os.path.dirname(default)) == os.path.join(os.path.dirname(build._PKG_DIR), "build")
    target = tmp_path / "libs"
    for _ in range(2):  # idempotent
        cache.setup_compilation_cache(str(target))
        moved = kernel_lib._paths(["spmm_rowmask"])["spmm_rowmask"]
        assert moved == str(target / "kernels" / os.path.basename(default))
    monkeypatch.setenv("STGRAPH_TPU_CACHE_DIR", str(tmp_path / "from_env"))
    cache.setup_compilation_cache()
    assert kernel_lib._paths(["spmm_rowmask"])["spmm_rowmask"].startswith(str(tmp_path / "from_env"))
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    with pytest.raises(OSError):
        cache.setup_compilation_cache(str(blocker / "sub"))
    build.set_build_root(None)
    assert kernel_lib._paths(["spmm_rowmask"])["spmm_rowmask"] == default
