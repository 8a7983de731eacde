"""Operator-overloading tracer: user closures → IR Programs.

Counterpart of ``stgraph_tpu/compiler/tracer.py``: a self-contained
``TracedValue`` replaces the reference's monkey-patch tracer
(``stgraph/compiler/stgraph.py:126-173``). Vertex programs use dunder
operators plus the ``dsl`` module's functions, and captured tensors, arrays
and scalars become PARAM leaves automatically.

Shape/dtype inference follows the reference's trick of executing every op
eagerly on a reduced probe tensor (``val/pytorch/torch_val.py:13-16``): each
``TracedValue`` carries a concrete (1, ...) CPU torch probe, so any
rank/broadcast error surfaces at trace time with a Python stack trace into
the user's formula. Feature specs carry torch dtypes (bf16 included, which
numpy lacks).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from stgraph_tpu_torch.compiler import registry
from stgraph_tpu_torch.compiler.ir import Program, Stmt, ValType, Var, infer_val_type
from stgraph_tpu_torch.compiler.node import CentralNode

__all__ = ["TracedValue", "TraceResult", "trace"]


class TracedValue:
    """Symbolic value; arithmetic appends Stmts to the active Program."""

    __array_priority__ = 1000  # ensure np arrays defer to our r-dunders

    def __init__(self, prog: Program, var: Var, probe: torch.Tensor) -> None:
        self.prog = prog
        self.var = var
        self.probe = probe

    # -- helpers -----------------------------------------------------------
    def _emit(self, op: str, args: List["TracedValue"], **kwargs) -> "TracedValue":
        fn = registry.lookup(op)
        probes = [a.probe for a in args]
        with torch.no_grad():
            out_probe = fn(*probes, **kwargs)
        vt = infer_val_type([a.var.val_type for a in args])
        ret = self.prog.new_var(vt, tuple(out_probe.shape[1:]), out_probe.dtype)
        self.prog.append(Stmt(op=op, args=[a.var for a in args], ret=ret, kwargs=kwargs, fn=fn))
        return TracedValue(self.prog, ret, out_probe)

    def _coerce(self, other: Any) -> "TracedValue":
        if isinstance(other, TracedValue):
            return other
        return _make_param(self.prog, other)

    def _binop(self, op: str, other: Any, reflected: bool = False) -> "TracedValue":
        other = self._coerce(other)
        args = [other, self] if reflected else [self, other]
        return self._emit(op, args)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        return self._binop("Add", other)

    def __radd__(self, other):
        # Python's builtin sum() starts from int 0: the hook that turns
        # ``sum([nb.h * nb.norm for nb in v.innbs])`` into a segment sum —
        # the same trick as the reference (``torch_val.py:117-127``).
        if isinstance(other, int) and other == 0:
            return self._agg("AggSum")
        return self._binop("Add", other, reflected=True)

    def __sub__(self, other):
        return self._binop("Sub", other)

    def __rsub__(self, other):
        return self._binop("Sub", other, reflected=True)

    def __mul__(self, other):
        return self._binop("Mul", other)

    def __rmul__(self, other):
        return self._binop("Mul", other, reflected=True)

    def __truediv__(self, other):
        return self._binop("TrueDiv", other)

    def __rtruediv__(self, other):
        return self._binop("TrueDiv", other, reflected=True)

    def __pow__(self, other):
        return self._binop("Pow", other)

    def __neg__(self):
        return self._emit("Neg", [self])

    # -- methods mirroring tensor API -------------------------------------
    def exp(self):
        return self._emit("Exp", [self])

    def log(self):
        return self._emit("Log", [self])

    def sqrt(self):
        return self._emit("Sqrt", [self])

    def abs(self):
        return self._emit("Abs", [self])

    def relu(self):
        return self._emit("Relu", [self])

    def sigmoid(self):
        return self._emit("Sigmoid", [self])

    def tanh(self):
        return self._emit("Tanh", [self])

    def clamp(self, min=None, max=None):
        return self._emit("Clamp", [self], min=min, max=max)

    def sum(self, axis=-1, keepdims=False):
        return self._emit("SumDim", [self], axis=axis, keepdims=keepdims)

    def max(self, axis=-1, keepdims=False):
        return self._emit("MaxDim", [self], axis=axis, keepdims=keepdims)

    def reshape(self, *shape):
        return self._emit("Reshape", [self], shape=tuple(shape))

    view = reshape

    @property
    def shape(self):
        return tuple(self.probe.shape[1:])

    # -- aggregation -------------------------------------------------------
    def _agg(self, op: str) -> "TracedValue":
        if self.var.val_type not in (ValType.SRC, ValType.EDGE):
            raise TypeError(
                f"can only aggregate SRC/EDGE values, got {self.var.val_type}"
            )
        reduce = registry.AGG_OPS[op]
        ret = self.prog.new_var(ValType.DEST, tuple(self.probe.shape[1:]), self.probe.dtype)
        self.prog.append(Stmt(op=op, args=[self.var], ret=ret, kwargs={"reduce": reduce}))
        return TracedValue(self.prog, ret, self.probe)

    def __repr__(self):
        return f"TracedValue({self.var})"

    # Guard against silent mis-tracing through unsupported protocols.
    def __iter__(self):
        raise TypeError("TracedValue is not iterable")

    def __bool__(self):
        raise TypeError(
            "TracedValue has no truth value; vertex programs must be "
            "control-flow free (they compile to one fused kernel)"
        )


def _make_param(prog: Program, value: Any) -> TracedValue:
    """Wrap a captured scalar/array/tensor as a PARAM leaf."""
    arr = np.asarray(value) if np.isscalar(value) else value
    shape = tuple(arr.shape)
    dtype = arr.dtype
    name = f"param:{len([k for k in prog.leaves if k.startswith('param:')])}"
    var = prog.add_leaf(name, ValType.PARAM, shape, dtype)
    probe = torch.ones((1,) + shape if shape else (1,), dtype=torch.float32)
    # PARAM probes keep a leading broadcast dim so they combine with entity
    # probes; the real value is bound at lowering.
    tv = TracedValue(prog, var, probe)
    prog.param_values = getattr(prog, "param_values", {})
    prog.param_values[name] = value
    return tv


class TraceResult:
    def __init__(self, prog: Program, output: Var, param_values: Dict[str, Any]):
        self.program = prog
        self.output = output
        self.param_values = param_values


def trace(
    f,
    n_feats_spec: Dict[str, Tuple[Tuple[int, ...], Any]],
    e_feats_spec: Dict[str, Tuple[Tuple[int, ...], Any]],
) -> TraceResult:
    """Run the user closure against a symbolic CentralNode.

    ``*_spec`` map feature name → (per-entity shape, torch dtype); e.g. an
    (N, F) node feature has per-entity shape (F,).
    """
    prog = Program()
    cen = CentralNode()
    for name, (shape, dtype) in n_feats_spec.items():
        dvar = prog.add_leaf(f"dst:{name}", ValType.DEST, shape, dtype)
        setattr(cen, name, TracedValue(prog, dvar, _probe(shape, dtype)))
        svar = prog.add_leaf(f"src:{name}", ValType.SRC, shape, dtype)
        for nb in cen.innbs:
            setattr(nb, name, TracedValue(prog, svar, _probe(shape, dtype)))
        # Out-direction: the neighbor across an out-edge plays the SRC role
        # in the transposed graph ('osrc' leaves; lowering swaps to csr_t).
        ovar = prog.add_leaf(f"osrc:{name}", ValType.SRC, shape, dtype)
        for nb in cen.outnbs:
            setattr(nb, name, TracedValue(prog, ovar, _probe(shape, dtype)))
    for name, (shape, dtype) in e_feats_spec.items():
        evar = prog.add_leaf(f"edge:{name}", ValType.EDGE, shape, dtype)
        for e in cen.inedges:
            setattr(e, name, TracedValue(prog, evar, _probe(shape, dtype)))
        oevar = prog.add_leaf(f"oedge:{name}", ValType.EDGE, shape, dtype)
        for e in cen.outedges:
            setattr(e, name, TracedValue(prog, oevar, _probe(shape, dtype)))

    out = f(cen)
    if not isinstance(out, TracedValue):
        raise TypeError("vertex program must return a traced value")
    replace = prog.cse()
    out_var = replace.get(out.var.id, out.var)
    prog.dce([out_var])
    return TraceResult(prog, out_var, getattr(prog, "param_values", {}))


def _probe(shape: Tuple[int, ...], dtype) -> torch.Tensor:
    return torch.ones((1,) + tuple(shape), dtype=dtype)
