"""CSR graph storage as torch tensors with a numpy host mirror.

Counterpart of ``stgraph_tpu/graph/csr.py``. The CSR is built on the host
(native counting sort, or numpy ``lexsort`` without a compiler), keeps the
numpy arrays as its host mirror (``host_arrays``) for layout passes, and
holds torch int32 tensors on one device. Padding edges carry the sentinel
row/col id ``num_nodes`` and the eid ``capacity``, exactly as in the JAX
package, so both packages build equal arrays from the same edge list.

A CSR may be rectangular: its columns index ``num_cols`` rows of a table
(default ``num_nodes``), as the distribution layer's shard CSRs do
(``parallel/partition.py``: ``[local | halo]`` columns, or the halo buffer
alone). Those pad ``cols`` with 0 as the JAX partitioner does, so only
``rows`` marks padding, and only the first ``num_edges`` slots are real.

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
    "csr_order",
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
      cols:    (capacity,) int32 — col id per edge; ``num_cols`` on padding
               (or 0, in the shard CSRs).
      eids:    (capacity,) int32 — original edge id per edge; ``capacity`` on
               padding.
      num_nodes: int, the rows (destinations).
      num_edges: number of real (non-padding) edges, the first slots.
      num_cols: int, the rows of the table the columns index (sources);
               ``num_nodes`` unless given.
    """

    def __init__(
        self,
        host: Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray],
        num_nodes: int,
        num_edges: int,
        device: torch.device,
        num_cols: Optional[int] = None,
    ) -> None:
        self._host = tuple(np.ascontiguousarray(a, np.int32) for a in host)
        self.num_nodes = int(num_nodes)
        self.num_edges = int(num_edges)
        self.num_cols = self.num_nodes if num_cols is None else int(num_cols)
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
        """(num_cols,) int32 — per-col edge counts over the real edges."""
        _, rows, cols, _ = self._host
        real = cols[rows < self.num_nodes]
        counts = np.bincount(real, minlength=self.num_cols).astype(np.int32)
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
        """``cols`` with the sentinel clamped to ``num_cols - 1``: a safe
        gather index (torch raises, and CUDA asserts, on the sentinel where
        XLA clamps). Padding entries must still be masked by the caller."""
        return self.cached(
            "cols_clamped", lambda: self.cols.clamp(max=max(self.num_cols - 1, 0))
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
        return CSR(self._host, self.num_nodes, self.num_edges, device, self.num_cols)

    def transpose(self) -> "CSR":
        """The transposed CSR (rows<->cols, ``num_nodes``<->``num_cols``),
        keeping ``eids``.

        Built on the host with a stable sort of the real edges by (col,
        row), as the JAX package does for a concrete CSR; the padding slots
        follow, with the sentinels ``num_cols`` (rows) and ``num_nodes``
        (cols). The native counting sort, where it builds, gives the same
        order as numpy's ``lexsort``.
        """

        def make():
            e, n, m = self.num_edges, self.num_nodes, self.num_cols
            _, rows, cols, eids = (a[:e] for a in self._host)
            order, indptr = csr_order(cols, rows, m, n)
            t_rows = np.full(self.capacity, m, np.int32)
            t_cols = np.full(self.capacity, n, np.int32)
            t_eids = np.full(self.capacity, self.capacity, np.int32)
            t_rows[:e], t_cols[:e], t_eids[:e] = cols[order], rows[order], eids[order]
            return CSR((indptr, t_rows, t_cols, t_eids), m, e, self.device, num_cols=n)

        return self.cached("transpose", make)

    def edge_perms(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(perm_t, perm_f, emask)`` between this CSR's edge order and its
        transpose's, as ``spmm_pallas._make_rowmask_spmm`` builds them.

        ``w[perm_t]`` is forward-order ``w`` in transpose order and
        ``dw_t[perm_f]`` the converse; both go through the shared ``eids``
        with the sentinel clamped to ``capacity`` (padding maps to some
        padding slot). ``emask`` is 1.0 on real edges, 0.0 on padding. The
        perms are int32 (for ``index_select``), built on the host once.
        """

        def make():
            n, cap = self.num_nodes, self.capacity
            _, rows, _, eids = self._host
            eids_t = self.transpose().host_arrays()[3]
            pos_in_fwd = np.zeros(cap + 1, np.int32)
            pos_in_fwd[np.minimum(eids, cap)] = np.arange(cap, dtype=np.int32)
            perm_t = pos_in_fwd[np.minimum(eids_t, cap)]
            pos_in_t = np.zeros(cap + 1, np.int32)
            pos_in_t[np.minimum(eids_t, cap)] = np.arange(cap, dtype=np.int32)
            perm_f = pos_in_t[np.minimum(eids, cap)]
            emask = (rows < n).astype(np.float32)
            return tuple(torch.from_numpy(a).to(self.device) for a in (perm_t, perm_f, emask))

        return self.cached("edge_perms", make)


def csr_order(
    dst: np.ndarray, src: np.ndarray, num_rows: int, num_cols: int
) -> Tuple[np.ndarray, np.ndarray]:
    """The stable (dst, src) order of an edge list, ``np.lexsort((src,
    dst))``'s, and the ``indptr`` of its ``num_rows`` rows.

    ``dst`` must lie in ``[0, num_rows)`` and ``src`` in ``[0, num_cols)``.
    The native counting sort gives the order where it builds (``lexsort``
    costs tens of seconds at 10^8 edges), numpy's ``lexsort`` otherwise.
    """
    from stgraph_tpu_torch import native

    dst = np.ascontiguousarray(dst, np.int32)
    src = np.ascontiguousarray(src, np.int32)
    e = dst.shape[0]
    if e and not (0 <= dst.min() and dst.max() < num_rows and 0 <= src.min() and src.max() < num_cols):
        raise ValueError(f"edge ids out of range: dst must lie in [0, {num_rows}) and src in [0, {num_cols})")
    built = native.build_csr_arrays(src, dst, max(num_rows, num_cols), e) if e else None
    if built is not None:
        # the labels of a positional edge list are its sorted order
        return built[3], np.ascontiguousarray(built[0][: num_rows + 1])
    order = np.lexsort((src, dst))
    indptr = np.zeros(num_rows + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=num_rows), out=indptr[1:])
    return order, indptr


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
    if capacity < e:
        raise ValueError(f"capacity {capacity} < num_edges {e}")
    # Stable sort by (dst, src); eid = original user position.
    order, indptr = csr_order(dst, src, int(num_nodes), int(num_nodes))
    rows = np.full(capacity, num_nodes, dtype=np.int32)
    cols = np.full(capacity, num_nodes, dtype=np.int32)
    eids = np.full(capacity, capacity, dtype=np.int32)
    rows[:e] = dst[order]
    cols[:e] = src[order]
    eids[:e] = order
    return CSR((indptr, rows, cols, eids), int(num_nodes), e, device)
