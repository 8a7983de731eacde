"""Traceable op registry: torch implementations keyed by op name.

Counterpart of ``stgraph_tpu/compiler/registry.py`` (``:26-50``): the same
op names, each re-expressed as a torch callable. Torch autograd
differentiates them, so no per-op gradient rule is needed.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

__all__ = ["ELEMENTWISE_OPS", "AGG_OPS", "lookup"]


def _leaky_relu(x, negative_slope=0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def _clamp(a, min=None, max=None):
    if min is None and max is None:
        return a  # jnp.clip(a, None, None) is the identity; torch.clamp raises
    return torch.clamp(a, min=min, max=max)


ELEMENTWISE_OPS: Dict[str, Callable] = {
    "Add": lambda a, b: a + b,
    "Sub": lambda a, b: a - b,
    "Mul": lambda a, b: a * b,
    "TrueDiv": lambda a, b: a / b,
    "Pow": lambda a, b: a**b,
    "Neg": lambda a: -a,
    "Exp": torch.exp,
    "Log": torch.log,
    "Sqrt": torch.sqrt,
    "Relu": torch.relu,
    "LeakyRelu": _leaky_relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Abs": torch.abs,
    "Clamp": _clamp,
    "Reshape": lambda a, shape=None: a.reshape(tuple(a.shape[:1]) + tuple(shape)),
    "SumDim": lambda a, axis=-1, keepdims=False: torch.sum(a, dim=axis, keepdim=keepdims),
    "MaxDim": lambda a, axis=-1, keepdims=False: torch.amax(a, dim=axis, keepdim=keepdims),
    "Cast": lambda a, dtype=None: a.to(dtype),
}

# Aggregations: edge domain -> dest domain. Implemented by the ops layer's
# segment reductions at lowering time.
AGG_OPS = {"AggSum": "sum", "AggMax": "max", "AggMin": "min", "AggMean": "mean"}


def lookup(op: str) -> Callable:
    return ELEMENTWISE_OPS[op]
