"""BlockedCSR: the chunk-aligned edge layout that the blocked SpMM kernel
K10 reads.

Counterpart of ``stgraph_tpu/graph/blocked.py``. Destination rows are taken
in blocks of ``ROW_BLOCK`` (128); each block's edges sit contiguously in CSR
order (so sorted by destination) and are padded with sentinel slots
(``dst = cols = num_nodes``, ``perm = eids = csr capacity``) up to a
multiple of ``EDGE_CHUNK`` (1024). ``perm`` maps a slot to its CSR edge
position and ``eids`` to its user edge id, so that per-edge values of the
forward and the transpose layouts can be exchanged.

The padding was forced by the TPU's DMA alignment; the Hopper kernel skips
sentinel slots wherever they sit. The layout itself is kept exactly as the
JAX package builds it, array for array, because it is the kernel's contract
and the tests hold the two packages' layouts equal.

The layout is built on the host (the native builder, or numpy without a
compiler) and placed on the CSR's device. ``blocked_layout`` builds it once
per CSR. The layout keeps the CSR's host ``indptr``, from which K10's work
list is built (``ops.spmm_blocked.k10_work_items``) and kept with it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR

__all__ = ["BlockedCSR", "EDGE_CHUNK", "ROW_BLOCK", "blocked_layout", "build_blocked"]

ROW_BLOCK = 128  # destination rows per block
EDGE_CHUNK = 1024  # each block's slot count is a multiple of this


class BlockedCSR:
    """Chunk-aligned edge layout, as int32 tensors on one device.

    Attributes:
      offsets: (NB,) — slot offset of each row block (a multiple of EDGE_CHUNK).
      counts:  (NB,) — padded slot count of each block (a multiple of EDGE_CHUNK).
      dst:     (CB,) — destination id per slot; ``num_nodes`` on padding.
      cols:    (CB,) — source id per slot; ``num_nodes`` on padding.
      perm:    (CB,) — CSR edge position per slot; ``csr_capacity`` on padding.
      eids:    (CB,) — user edge id per slot; ``csr_capacity`` on padding.
      num_nodes, num_rows_padded, csr_capacity: ints.
      host_indptr: (num_nodes + 1,) int64 numpy, the CSR's row pointer.
    """

    def __init__(self, arrays, num_nodes: int, num_rows_padded: int, csr_capacity: int, device,
                 host_indptr: np.ndarray) -> None:
        self.offsets, self.counts, self.dst, self.cols, self.perm, self.eids = (
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device) for a in arrays
        )
        self.host_offsets = np.asarray(arrays[0], np.int64)
        self.host_indptr = np.asarray(host_indptr, np.int64)
        self.num_nodes = int(num_nodes)
        self.num_rows_padded = int(num_rows_padded)
        self.csr_capacity = int(csr_capacity)
        self._cache: Dict[str, Any] = {}

    def cached(self, key: str, make: Callable[[], Any]) -> Any:
        """Memoize a structure derived from this layout (K10's work list)."""
        if key not in self._cache:
            with torch.inference_mode(False):
                self._cache[key] = make()
        return self._cache[key]

    @property
    def num_blocks(self) -> int:
        return self.num_rows_padded // ROW_BLOCK

    @property
    def capacity(self) -> int:
        return self.dst.shape[0]

    @property
    def device(self) -> torch.device:
        return self.dst.device


def build_blocked(csr: CSR, edge_chunk: int = EDGE_CHUNK) -> BlockedCSR:
    """The blocked layout of ``csr``, built on the host, on ``csr.device``."""
    n = csr.num_nodes
    indptr, rows, cols, csr_eids = csr.host_arrays()
    cap = csr.capacity
    n_pad = max(((n + ROW_BLOCK - 1) // ROW_BLOCK) * ROW_BLOCK, ROW_BLOCK)

    from stgraph_tpu_torch import native

    built = native.build_blocked_arrays(indptr, rows, cols, csr_eids, n, cap, ROW_BLOCK, edge_chunk)
    if built is not None:
        return BlockedCSR(built, n, n_pad, cap, csr.device, indptr)

    nb = n_pad // ROW_BLOCK
    lo = np.minimum(np.arange(nb) * ROW_BLOCK, n)
    hi = np.minimum(lo + ROW_BLOCK, n)
    starts = indptr[lo].astype(np.int64)
    raw_counts = indptr[hi].astype(np.int64) - starts
    pad_counts = ((raw_counts + edge_chunk - 1) // edge_chunk) * edge_chunk
    offsets = np.zeros(nb, dtype=np.int64)
    np.cumsum(pad_counts[:-1], out=offsets[1:])
    total = max(int(offsets[-1] + pad_counts[-1]), edge_chunk)

    bdst = np.full(total, n, dtype=np.int32)
    bcols = np.full(total, n, dtype=np.int32)
    bperm = np.full(total, cap, dtype=np.int32)
    beids = np.full(total, cap, dtype=np.int32)
    # each real edge's slot: its block's offset plus its rank in the block
    e = int(indptr[-1])
    block = np.minimum(rows[:e], n - 1) // ROW_BLOCK
    slot = offsets[block] + np.arange(e) - starts[block]
    bdst[slot] = rows[:e]
    bcols[slot] = cols[:e]
    bperm[slot] = np.arange(e, dtype=np.int32)
    beids[slot] = csr_eids[:e]
    return BlockedCSR((offsets, pad_counts, bdst, bcols, bperm, beids), n, n_pad, cap, csr.device, indptr)


def blocked_layout(csr: CSR) -> BlockedCSR:
    """``build_blocked(csr)``, built once per CSR and kept with it."""
    return csr.cached("blocked", lambda: build_blocked(csr))
