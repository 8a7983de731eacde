"""STGraph compile decorator: the user entry point to the vertex compiler.

Counterpart of ``stgraph_tpu/compiler/stgraph.py``: ``STGraph().compile()``
returns a ``Context`` that traces the (tiny) closure and runs the lowered
torch function on every call. Torch is eager, so there is no executor
cache to keep; tracing a one-line program costs microseconds.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from stgraph_tpu_torch.compiler.lowering import GraphView, lower
from stgraph_tpu_torch.compiler.tracer import trace
from stgraph_tpu_torch.graph.csr import CSR

__all__ = ["STGraph", "Context"]


class Context:
    """A compiled vertex program; call with ``(g, n_feats, e_feats)``."""

    def __init__(self, f: Callable, impl: str = "auto") -> None:
        self._f = f
        self._impl = impl
        self.__name__ = getattr(f, "__name__", "vertex_program")

    def __call__(
        self,
        g,
        n_feats: Optional[Dict[str, Any]] = None,
        e_feats: Optional[Dict[str, Any]] = None,
    ):
        gv = _as_view(g)
        dev = gv.csr.device
        n_feats = {k: _as_tensor(v, dev) for k, v in (n_feats or {}).items()}
        e_feats = {k: _as_tensor(v, dev) for k, v in (e_feats or {}).items()}
        nspec = {k: (tuple(v.shape[1:]), v.dtype) for k, v in n_feats.items()}
        espec = {k: (tuple(v.shape[1:]), v.dtype) for k, v in e_feats.items()}
        tr = trace(self._f, nspec, espec)
        fn = lower(tr, impl=self._impl)
        return fn(gv, n_feats, e_feats)


class STGraph:
    """Factory for compiled vertex programs.

    ``backend`` is accepted for signature parity with the reference
    (``STGraph(STGraphBackendTorch())``) but ignored.
    """

    def __init__(self, backend: Any = None) -> None:
        self._backend = backend

    def compile(
        self, gnn_module: Any = None, impl: str = "auto"
    ) -> Callable[[Callable], Context]:
        """Decorator: ``@stgraph.compile()`` over a ``f(v) -> value`` closure.

        ``gnn_module`` is accepted for parity; captured tensors are picked
        up automatically as PARAM leaves. ``impl`` routes aggregation:
        'auto' | 'torch' | 'dense' | 'kernel'.
        """

        def decorator(f: Callable) -> Context:
            return Context(f, impl=impl)

        return decorator


def _as_view(g) -> GraphView:
    """Normalize any graph handle (CSR, StaticGraph, ...) into a GraphView."""
    if isinstance(g, GraphView):
        return g
    if isinstance(g, CSR):
        return GraphView(csr=g)
    fwd = getattr(g, "fwd_csr", None)
    if fwd is not None:
        return GraphView(csr=fwd, csr_t=getattr(g, "bwd_csr", None))
    raise TypeError(f"cannot extract a graph view from {type(g)!r}")


def _as_tensor(v, device: torch.device) -> torch.Tensor:
    """Features as tensors on the graph's device; tensors already there
    pass through unchanged (autograd history included)."""
    if torch.is_tensor(v):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)
