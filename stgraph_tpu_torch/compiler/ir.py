"""Graph IR for traced vertex programs: Var, Stmt, Program.

A copy of ``stgraph_tpu/compiler/ir.py`` (numpy only; the port imports
nothing of the JAX package). A slimmed-down, functional analogue of the
reference IR (``stgraph/compiler/program.py``: ``Var``/``Stmt``/``Program``
as a mutable doubly-linked statement list with users-maps and grad links).
Torch autograd supplies autodiff, so this IR only has to describe the
*forward* dataflow
from feature leaves to the returned value; it needs no grad links, no
materialization planning, and no linked-list surgery — a flat SSA statement
list suffices.

Domain taxonomy (``ValType``) is the reference's
(``stgraph/compiler/utils.py:15-25``):

  * ``SRC``   — per-source-node value, materialized as an (N, ...) array,
                gathered by edge source ids when used per-edge;
  * ``DEST``  — per-destination-node value ((N, ...) array, gathered by edge
                destination ids when used per-edge);
  * ``EDGE``  — per-edge value ((capacity, ...) array in CSR order);
  * ``PARAM`` — graph-independent captured constant/parameter.

``OpType`` S/E/A/D (nodewise-on-src / edgewise / aggregation / nodewise-on-
dest) is implied by the argument/result domains, so it is not stored.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["ValType", "Var", "Stmt", "Program"]


class ValType(enum.Enum):
    SRC = "src"
    DEST = "dest"
    EDGE = "edge"
    PARAM = "param"


_DOMAIN_RANK = {ValType.PARAM: 0, ValType.SRC: 1, ValType.DEST: 1, ValType.EDGE: 2}


def infer_val_type(types: Sequence[ValType]) -> ValType:
    """Combine operand domains for an elementwise op.

    Same rules as the reference's ``infer_val_type``
    (``compiler/utils.py:50-65``): mixing SRC and DEST yields EDGE; EDGE
    absorbs everything; PARAM is neutral.
    """
    non_param = [t for t in types if t is not ValType.PARAM]
    if not non_param:
        return ValType.PARAM
    if ValType.EDGE in non_param:
        return ValType.EDGE
    uniq = set(non_param)
    if uniq == {ValType.SRC, ValType.DEST}:
        return ValType.EDGE
    return non_param[0]


@dataclass(eq=False)
class Var:
    """SSA value. ``leaf`` names bind to runtime inputs at lowering."""

    id: int
    val_type: ValType
    shape: Tuple[int, ...]  # per-entity shape (feature dims only)
    dtype: Any
    leaf: Optional[str] = None  # feature name for leaves; None for temps
    producer: Optional["Stmt"] = None

    def __repr__(self) -> str:
        tag = f":{self.leaf}" if self.leaf else ""
        return f"V{self.id}[{self.val_type.value}{tag}{list(self.shape)}]"


@dataclass(eq=False)
class Stmt:
    """One traced operation: ``ret = fn(*args, **kwargs)``.

    ``fn`` is the torch implementation applied to materialized operand
    tensors at lowering time — the analogue of the reference's per-op
    ``gen_code`` CUDA expression emitters (``compiler/registry.py``).
    """

    op: str
    args: List[Var]
    ret: Var
    kwargs: Dict[str, Any] = field(default_factory=dict)
    fn: Optional[Callable] = None

    def __repr__(self) -> str:
        return f"{self.ret} = {self.op}({', '.join(map(str, self.args))})"


class Program:
    """Flat SSA statement list built during tracing."""

    def __init__(self) -> None:
        self.stmts: List[Stmt] = []
        self._ids = itertools.count()
        self.leaves: Dict[str, Var] = {}

    def new_var(
        self,
        val_type: ValType,
        shape: Tuple[int, ...],
        dtype: Any,
        leaf: Optional[str] = None,
    ) -> Var:
        return Var(next(self._ids), val_type, tuple(shape), dtype, leaf=leaf)

    def add_leaf(
        self, name: str, val_type: ValType, shape: Tuple[int, ...], dtype: Any
    ) -> Var:
        v = self.new_var(val_type, shape, dtype, leaf=name)
        self.leaves[name] = v
        return v

    def append(self, stmt: Stmt) -> Stmt:
        stmt.ret.producer = stmt
        self.stmts.append(stmt)
        return stmt

    def dce(self, outputs: Sequence[Var]) -> None:
        """Dead-code elimination (reference ``passes/dce.py``)."""
        live = {v.id for v in outputs}
        keep: List[Stmt] = []
        for stmt in reversed(self.stmts):
            if stmt.ret.id in live:
                keep.append(stmt)
                live.update(a.id for a in stmt.args)
        self.stmts = list(reversed(keep))

    def cse(self) -> Dict[int, Var]:
        """Common-subexpression elimination by structural key
        (reference ``passes/cse.py``: keyed on ``stmt_info``).
        Returns the var-replacement map so callers can remap outputs."""
        seen: Dict[str, Var] = {}
        replace: Dict[int, Var] = {}
        new_stmts: List[Stmt] = []
        for stmt in self.stmts:
            args = [replace.get(a.id, a) for a in stmt.args]
            key = (
                stmt.op,
                tuple(a.id for a in args),
                tuple(sorted((k, repr(v)) for k, v in stmt.kwargs.items())),
            )
            key = repr(key)
            if key in seen:
                replace[stmt.ret.id] = seen[key]
            else:
                stmt.args = args
                seen[key] = stmt.ret
                new_stmts.append(stmt)
        self.stmts = new_stmts
        return replace

    def __repr__(self) -> str:
        return "\n".join(map(repr, self.stmts))
