"""Abstract base class for all graph types.

Counterpart of ``stgraph_tpu/graph/stgraph_base.py``: node/edge data
dictionaries and the abstract surface shared by static and dynamic graphs.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional


class STGraphBase(ABC):
    """Common node/edge-data bookkeeping for static and dynamic graphs."""

    def __init__(self) -> None:
        self._ndata: Dict[str, Any] = {}
        self._edata: Dict[str, Any] = {}
        self._forward_graph = None
        self._backward_graph = None

    # -- data dictionaries -------------------------------------------------
    def get_ndata(self, field: str) -> Optional[Any]:
        return self._ndata.get(field)

    def set_ndata(self, field: str, val: Any) -> None:
        self._ndata[field] = val

    def get_edata(self, field: str) -> Optional[Any]:
        return self._edata.get(field)

    def set_edata(self, field: str, val: Any) -> None:
        self._edata[field] = val

    # -- abstract surface ----------------------------------------------------
    @abstractmethod
    def get_num_nodes(self) -> int: ...

    @abstractmethod
    def get_num_edges(self) -> int: ...

    @abstractmethod
    def graph_type(self) -> str: ...
