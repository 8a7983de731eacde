"""ctypes binding for the port's native host-side graph builder.

Counterpart of ``stgraph_tpu/native/__init__.py`` (``build_csr``,
``build_blocked`` and ``reorder_locality``): the library is built with
``g++`` at first use into ``build/native/`` and loaded with ctypes. Without
a compiler ``build_csr_arrays``, ``build_blocked_arrays`` and
``reorder_locality`` return None, and ``graph.csr.build_csr``,
``graph.blocked.build_blocked`` and ``graph.reorder.locality_order`` take
their numpy paths, which give the same arrays.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

from stgraph_tpu_torch.utils.build import library_path

__all__ = ["available", "build_blocked_arrays", "build_csr_arrays", "reorder_locality"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "graph_builder.cpp")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compile(out: str) -> bool:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(out))
    os.close(fd)
    try:
        subprocess.run(
            [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC],
            check=True,
            capture_output=True,
            timeout=300,
        )
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path("native", "graph_builder", _SRC)
    if not os.path.exists(path) and not _compile(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.build_csr.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i32p, i32p, i32p, i32p,
    ]
    lib.build_csr.restype = ctypes.c_int
    lib.blocked_sizes.argtypes = [
        i32p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i64p, i64p,
    ]
    lib.blocked_sizes.restype = ctypes.c_int64
    lib.build_blocked.argtypes = [
        i32p, i32p, i32p, i32p, ctypes.c_int32, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, i64p, ctypes.c_int64,
        i32p, i32p, i32p, i32p,
    ]
    lib.build_blocked.restype = ctypes.c_int
    lib.reorder_locality.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p]
    lib.reorder_locality.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_csr_arrays(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, capacity: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """(indptr, rows, cols, eids) via the native builder, or None."""
    lib = _load()
    if lib is None:
        return None
    e = len(src)
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    indptr = np.empty(num_nodes + 1, np.int32)
    rows = np.empty(capacity, np.int32)
    cols = np.empty(capacity, np.int32)
    eids = np.empty(capacity, np.int32)
    rc = lib.build_csr(src, dst, e, num_nodes, capacity, indptr, rows, cols, eids)
    if rc != 0:
        return None
    return indptr, rows, cols, eids


def build_blocked_arrays(
    indptr: np.ndarray,
    rows: np.ndarray,
    cols: np.ndarray,
    eids: np.ndarray,
    num_nodes: int,
    capacity: int,
    row_block: int,
    edge_chunk: int,
):
    """(offsets, counts, bdst, bcols, bperm, beids) via the native builder,
    or None."""
    lib = _load()
    if lib is None:
        return None
    n_pad = max(((num_nodes + row_block - 1) // row_block) * row_block, row_block)
    nb = n_pad // row_block
    offsets = np.empty(nb, np.int64)
    counts = np.empty(nb, np.int64)
    indptr = np.ascontiguousarray(indptr, np.int32)
    total = lib.blocked_sizes(indptr, num_nodes, row_block, edge_chunk, offsets, counts)
    bdst, bcols, bperm, beids = (np.empty(total, np.int32) for _ in range(4))
    rc = lib.build_blocked(
        indptr,
        np.ascontiguousarray(rows, np.int32),
        np.ascontiguousarray(cols, np.int32),
        np.ascontiguousarray(eids, np.int32),
        num_nodes, capacity, row_block, edge_chunk, offsets, total,
        bdst, bcols, bperm, beids,
    )
    if rc != 0:
        return None
    return offsets, counts, bdst, bcols, bperm, beids


def reorder_locality(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> Optional[np.ndarray]:
    """The label-propagation locality order via the native builder
    (``order[k]`` is the old id of the node at new position ``k``), or
    None."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    order = np.empty(num_nodes, np.int32)
    rc = lib.reorder_locality(src, dst, len(src), num_nodes, order)
    if rc != 0:
        return None
    return order
