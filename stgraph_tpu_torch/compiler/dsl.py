"""Vertex-program DSL functions: aggregators and elementwise math.

The reference relies on Python builtins and monkey-patched torch functions
inside vertex closures (``sum()`` → AggSum via ``__radd__``; ``torch.exp`` →
a patched ``TorchOp``). Builtin ``sum()`` works identically here, but
builtin ``max()`` over the single symbolic neighbor is a silent no-op (see
``segment.segment_softmax``'s docstring), so proper aggregators are
exported explicitly. Elementwise helpers mirror the reference's traced op
set (``compiler/registry.py:195-406``). A copy of
``stgraph_tpu/compiler/dsl.py``.

Usage::

    from stgraph_tpu_torch.compiler import dsl

    @stgraph.compile()
    def nb_forward(v):
        embs = [nb.el + v.er for nb in v.innbs]
        m = dsl.agg_max(embs)                       # true segment max
        coeff = [dsl.exp(dsl.leaky_relu(e - m.dst())) for e in embs]
        ...
"""

from __future__ import annotations

from stgraph_tpu_torch.compiler.tracer import TracedValue

__all__ = [
    "agg_sum",
    "agg_max",
    "agg_min",
    "agg_mean",
    "exp",
    "log",
    "sqrt",
    "relu",
    "leaky_relu",
    "sigmoid",
    "tanh",
    "clamp",
]


def _one(xs) -> TracedValue:
    if isinstance(xs, TracedValue):
        return xs
    xs = list(xs)
    if len(xs) != 1 or not isinstance(xs[0], TracedValue):
        raise TypeError(
            "aggregators take the single-element list produced by a "
            "comprehension over v.innbs / v.inedges"
        )
    return xs[0]


def agg_sum(xs) -> TracedValue:
    """Segment sum over in-edges (equivalent to builtin ``sum(xs)``)."""
    return _one(xs)._agg("AggSum")


def agg_max(xs) -> TracedValue:
    """Segment max over in-edges — the stable-softmax shift for attention."""
    return _one(xs)._agg("AggMax")


def agg_min(xs) -> TracedValue:
    return _one(xs)._agg("AggMin")


def agg_mean(xs) -> TracedValue:
    """Segment mean (sum / in-degree, reference ``registry.py:96-99``)."""
    return _one(xs)._agg("AggMean")


def exp(x: TracedValue) -> TracedValue:
    return x.exp()


def log(x: TracedValue) -> TracedValue:
    return x.log()


def sqrt(x: TracedValue) -> TracedValue:
    return x.sqrt()


def relu(x: TracedValue) -> TracedValue:
    return x.relu()


def leaky_relu(x: TracedValue, negative_slope: float = 0.01) -> TracedValue:
    return x._emit("LeakyRelu", [x], negative_slope=negative_slope)


def sigmoid(x: TracedValue) -> TracedValue:
    return x.sigmoid()


def tanh(x: TracedValue) -> TracedValue:
    return x.tanh()


def clamp(x: TracedValue, min=None, max=None) -> TracedValue:
    return x.clamp(min=min, max=max)
