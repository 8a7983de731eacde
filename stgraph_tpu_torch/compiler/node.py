"""Vertex abstraction for traced programs: CentralNode, NbNode, NbEdge.

API-parity with the reference ``stgraph/compiler/node.py``: a vertex program
receives a ``CentralNode`` ``v`` with

  * ``v.<feat>``      — destination-node features (ValType.DEST),
  * ``v.innbs``       — a single symbolic in-neighbor; ``nb.<feat>`` are
                        source-node features (ValType.SRC),
  * ``v.inedges``     — symbolic in-edges with ``e.src``/``e.dst`` node
                        handles and ``e.<feat>`` edge features (ValType.EDGE).

The reference's ``update_allnode`` (temporal feature rebinding via GTypeCast
statements, ``node.py:28-37``) is unnecessary here: programs are retraced
on every call, so rebinding is just Python attribute assignment.

A copy of ``stgraph_tpu/compiler/node.py``.
"""

from __future__ import annotations

__all__ = ["CentralNode", "NbNode", "NbEdge", "EdgeDirection"]

import enum


class EdgeDirection(enum.Enum):
    IN = "in"
    OUT = "out"


class NbNode:
    """Symbolic neighbor node; traced features are set as attributes."""

    def __init__(self, center: "CentralNode", direction: EdgeDirection) -> None:
        self._central_node = center
        self._direction = direction


class NbEdge:
    """Symbolic incident edge with ``src``/``dst`` node handles."""

    def __init__(
        self, center: "CentralNode", direction: EdgeDirection, nbnode: NbNode
    ) -> None:
        self._direction = direction
        if direction == EdgeDirection.IN:
            self.src, self.dst = nbnode, center
        else:
            self.src, self.dst = center, nbnode


class CentralNode:
    """The traced vertex. One symbolic in-neighbor / in-edge suffices: every
    per-edge statement is implicitly batched over the edge set (the
    reference makes the same single-symbolic-neighbor choice,
    ``node.py:21-26``)."""

    def __init__(self) -> None:
        self.innbs = [NbNode(self, EdgeDirection.IN)]
        self.inedges = [NbEdge(self, EdgeDirection.IN, self.innbs[0])]
        # Out-direction (reference ``node.py:21-26``): aggregations over
        # ``v.outnbs`` / ``v.outedges`` lower against the transpose CSR. A
        # single program must stick to one direction (checked at lowering).
        self.outnbs = [NbNode(self, EdgeDirection.OUT)]
        self.outedges = [NbEdge(self, EdgeDirection.OUT, self.outnbs[0])]
