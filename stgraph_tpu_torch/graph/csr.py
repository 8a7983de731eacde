"""CSR graph storage as torch tensors with a numpy host mirror.

Counterpart of ``stgraph_tpu/graph/csr.py``. The CSR is built on the host
(native counting sort, or numpy ``lexsort`` without a compiler), keeps the
numpy arrays as its host mirror (``host_arrays``) for layout passes, and
holds torch int32 tensors on one device. Padding edges carry the sentinel
row/col id ``num_nodes`` and the eid ``capacity``, exactly as in the JAX
package, so both packages build equal arrays from the same edge list.

The pytree protocol has no counterpart: torch needs none. ``to(device)``
takes its place for moving the structure.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from stgraph_tpu_torch.utils.device import resolve_device

__all__ = [
    "CSR",
    "build_csr",
    "pad_edges",
    "round_up",
]


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m``."""
    return ((x + m - 1) // m) * m


class CSR:
    """A padded CSR adjacency in row-major edge order.

    For the forward (message-passing) graph, ``rows`` are destination node
    ids and ``cols`` are source node ids.

    Attributes:
      indptr:  (num_nodes + 1,) int32 — row offsets into the edge arrays.
      rows:    (capacity,) int32 — row id per edge; ``num_nodes`` on padding.
      cols:    (capacity,) int32 — col id per edge; ``num_nodes`` on padding.
      eids:    (capacity,) int32 — original edge id per edge; ``capacity`` on
               padding.
      num_nodes: int.
      num_edges: number of real (non-padding) edges.
    """

    def __init__(
        self,
        host: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        num_nodes: int,
        num_edges: int,
        device: torch.device,
    ) -> None:
        self._host = tuple(np.ascontiguousarray(a, np.int32) for a in host)
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)
        self.indptr, self.rows, self.cols, self.eids = (
            torch.from_numpy(a).to(device) for a in self._host
        )
        self._cache: Dict[str, Any] = {}

    # -- host mirror ------------------------------------------------------
    def host_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(indptr, rows, cols, eids) as numpy, for host-side layout passes."""
        return self._host

    # -- basic properties ------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def capacity(self) -> int:
        """Padded edge capacity."""
        return self._host[1].shape[0]

    @property
    def edge_mask(self) -> torch.Tensor:
        """(capacity,) bool — True on real edges, False on padding."""
        return self.rows < self.num_nodes

    def degrees(self) -> torch.Tensor:
        """(num_nodes,) int32 — per-row edge counts."""
        return self.indptr[1:] - self.indptr[:-1]

    def col_degrees(self) -> torch.Tensor:
        """(num_nodes,) int32 — per-col edge counts."""
        n = self.num_nodes
        cols = self._host[2]
        counts = np.bincount(cols[cols < n], minlength=n).astype(np.int32)
        return torch.from_numpy(counts).to(self.device)

    def cached(self, key: str, make: Callable[[], Any]) -> Any:
        """Memoize a structure derived from this CSR (norms, clamped ids,
        kernel work lists). Built outside inference mode, so a value first
        made while serving can later take part in autograd."""
        if key not in self._cache:
            with torch.inference_mode(False):
                self._cache[key] = make()
        return self._cache[key]

    @property
    def cols_clamped(self) -> torch.Tensor:
        """``cols`` with the sentinel clamped to ``num_nodes - 1``: a safe
        gather index (torch raises, and CUDA asserts, on the sentinel where
        XLA clamps). Padding entries must still be masked by the caller."""
        return self.cached(
            "cols_clamped", lambda: self.cols.clamp(max=max(self.num_nodes - 1, 0))
        )

    @property
    def rows_clamped(self) -> torch.Tensor:
        """``rows`` with the sentinel clamped, as ``cols_clamped``."""
        return self.cached(
            "rows_clamped", lambda: self.rows.clamp(max=max(self.num_nodes - 1, 0))
        )

    # -- derived structures ----------------------------------------------
    def to(self, device) -> "CSR":
        """This CSR on ``device`` (self when already there)."""
        device = torch.device(device)
        if device == self.device or (
            device.index is None and device.type == self.device.type
        ):
            return self
        return CSR(self._host, self.num_nodes, self.num_edges, device)

    def transpose(self) -> "CSR":
        """The transposed CSR (rows<->cols), keeping ``eids``.

        Built on the host with a stable sort by (col, row), as the JAX
        package does for a concrete CSR; padding (col == n) sorts last.
        """

        def make():
            n = self.num_nodes
            _, rows, cols, eids = self._host
            order = np.lexsort((rows, cols))
            t_rows, t_cols, t_eids = cols[order], rows[order], eids[order]
            counts = np.bincount(t_rows[t_rows < n], minlength=n)
            indptr = np.zeros(n + 1, dtype=np.int32)
            np.cumsum(counts, out=indptr[1:])
            return CSR((indptr, t_rows, t_cols, t_eids), n, self.num_edges, self.device)

        return self.cached("transpose", make)


def pad_edges(
    src: np.ndarray, dst: np.ndarray, num_nodes: int, capacity: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad (src, dst) edge arrays to ``capacity`` with sentinel ids."""
    e = len(src)
    if capacity < e:
        raise ValueError(f"capacity {capacity} < num_edges {e}")
    psrc = np.full(capacity, num_nodes, dtype=np.int32)
    pdst = np.full(capacity, num_nodes, dtype=np.int32)
    peid = np.full(capacity, capacity, dtype=np.int32)
    psrc[:e] = src
    pdst[:e] = dst
    peid[:e] = np.arange(e, dtype=np.int32)
    return psrc, pdst, peid


def build_csr(
    src,
    dst,
    num_nodes: int,
    capacity: Optional[int] = None,
    pad_multiple: int = 8,
    device=None,
) -> CSR:
    """Build a row-major (row=dst) CSR from an edge list, on the host.

    Edges are sorted by (dst, src) and ``eids`` label edges by their user
    position, as ``stgraph_tpu.graph.csr.build_csr`` does. The tensors are
    placed on ``device`` (default ``cuda``).
    """
    device = resolve_device(device)
    src = np.asarray(src, dtype=np.int32).reshape(-1)
    dst = np.asarray(dst, dtype=np.int32).reshape(-1)
    if src.shape != dst.shape:
        raise ValueError("src and dst must have the same length")
    e = len(src)
    if capacity is None:
        capacity = round_up(max(e, 1), pad_multiple)

    from stgraph_tpu_torch import native

    built = native.build_csr_arrays(src, dst, int(num_nodes), int(capacity))
    if built is not None:
        return CSR(built, int(num_nodes), e, device)

    if capacity < e:
        raise ValueError(f"capacity {capacity} < num_edges {e}")
    # Stable sort by (dst, src); eid = original user position.
    order = np.lexsort((src, dst))
    rows = np.full(capacity, num_nodes, dtype=np.int32)
    cols = np.full(capacity, num_nodes, dtype=np.int32)
    eids = np.full(capacity, capacity, dtype=np.int32)
    rows[:e] = dst[order]
    cols[:e] = src[order]
    eids[:e] = np.arange(e, dtype=np.int32)[order]

    counts = np.bincount(dst, minlength=num_nodes).astype(np.int64)
    indptr = np.zeros(num_nodes + 1, dtype=np.int32)
    np.cumsum(counts, out=indptr[1:])
    return CSR((indptr, rows, cols, eids), int(num_nodes), e, device)
