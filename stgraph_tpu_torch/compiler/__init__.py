"""Vertex-centric compiler: tracer → IR → lowering to torch ops and kernels.

Counterpart of ``stgraph_tpu/compiler/``. Torch autograd differentiates the
lowered function; the lowering routes aggregation patterns into the dense
path or the hand-written SpMM kernel.
"""

from stgraph_tpu_torch.compiler import debugging, dsl
from stgraph_tpu_torch.compiler.ir import Program, Stmt, ValType, Var
from stgraph_tpu_torch.compiler.lowering import lower
from stgraph_tpu_torch.compiler.node import CentralNode, NbEdge, NbNode
from stgraph_tpu_torch.compiler.stgraph import Context, STGraph
from stgraph_tpu_torch.compiler.tracer import TracedValue, trace

__all__ = [
    "CentralNode",
    "debugging",
    "Context",
    "NbEdge",
    "NbNode",
    "Program",
    "STGraph",
    "Stmt",
    "TracedValue",
    "ValType",
    "Var",
    "dsl",
    "lower",
    "trace",
]
