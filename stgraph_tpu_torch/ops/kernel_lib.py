"""Build and load the hand-written CUDA kernels in ``stgraph_tpu_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, under ``build/kernels/`` beside the
package, at first use; the wrappers load it with ctypes. ``build()``
starts one ``nvcc`` per stale source, all at once, and waits for them. A
library's name carries a hash of its source, so an edited kernel is always
rebuilt. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Dict, Iterable, List, Optional

from stgraph_tpu_torch.utils.build import library_path

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "load"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

# kernel library name -> source file in csrc/
SOURCES: Dict[str, str] = {
    "spmm_rowmask": "spmm_rowmask.cu",  # K1
    "spmm_sddmm_rowmask": "spmm_sddmm_rowmask.cu",  # K2
    "segment_sum_narrow": "segment_sum_narrow.cu",  # K3
    "segment_max_narrow": "segment_max_narrow.cu",  # K4
    "spmm_rowid": "spmm_rowid.cu",  # K6
    "rowid_denom": "rowid_denom.cu",  # K7
    "flash_gat_fwd": "flash_gat_fwd.cu",  # K8
    "flash_gat_bwd": "flash_gat_bwd.cu",  # K9
    "segment_sum_blocked": "segment_sum_blocked.cu",  # K10
}

NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            found = os.path.join(CUDA_HOME, "bin", "nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            "stgraph_tpu_torch/csrc at first use and need the CUDA toolkit"
        )
    return found


def _paths(names: Iterable[str]) -> Dict[str, str]:
    return {n: library_path("kernels", n, os.path.join(_CSRC, SOURCES[n])) for n in names}


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the kernels ``names`` (default: all) that are not built yet,
    in parallel. Returns the compiler's messages (``-Xptxas=-v`` register and
    shared-memory report) for each kernel compiled by this call; raises
    ``RuntimeError`` with the compiler's output if one fails."""
    paths = _paths(list(names) if names is not None else list(SOURCES))
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    logs, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        try:
            text, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            errors.append(f"{name}: nvcc timed out\n{text}")
            continue
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            if os.path.exists(tmp):
                os.unlink(tmp)
            continue
        os.replace(tmp, out)
        logs[name] = text
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, with ``argtypes`` set
    from ``signatures`` (function -> ctypes argument types; every function
    returns a ``cudaError_t`` as int)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(_paths([name])[name])
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
