"""Lowering: traced IR Programs → torch functions over CSR graphs.

Counterpart of ``stgraph_tpu/compiler/lowering.py``. Domain
materialization rules (see ``ir.ValType``):

  * SRC/DEST statements evaluate on (N, ...) node tensors;
  * EDGE statements evaluate on (capacity, ...) edge tensors, with node
    operands gathered through ``csr.cols`` (SRC) / ``csr.rows`` (DEST);
  * aggregations segment-reduce edge tensors into DEST node tensors.

The **SpMM peephole** recognizes ``AggSum(Mul-chain)`` where the chain
contains exactly one "wide" SRC feature and any number of per-edge scalar
factors, and emits ``ops.message.spmm`` (dense adjacency or the K1 kernel)
unchanged from the JAX package.

Two differences, both from torch being eager where JAX traces:

  * there is no constant folding (``_fold``): every statement simply runs;
  * the sentinel id ``num_nodes`` on padding edges is clamped to
    ``num_nodes - 1`` before a gather (XLA clamps by itself; torch raises on
    the CPU and asserts on CUDA), and no gradient flows back through it, as
    in XLA (``ops.segment.gather_rows``). Aggregations mask those entries.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from stgraph_tpu_torch.compiler.ir import Stmt, ValType, Var
from stgraph_tpu_torch.compiler.tracer import TraceResult
from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import message as M

__all__ = ["GraphView", "lower"]


class GraphView(NamedTuple):
    """The forward CSR and, when known, its transpose."""

    csr: CSR
    csr_t: Optional[CSR] = None


def lower(tr: TraceResult, impl: str = "auto") -> Callable:
    """Build ``fn(graph_view, n_feats, e_feats) -> tensor`` from a trace."""
    prog, out_var = tr.program, tr.output
    param_values = tr.param_values

    # Direction: 'osrc'/'oedge' leaves mean the program aggregates over
    # out-edges; it then lowers against the transposed CSR. Mixing
    # directions in one program is rejected.
    used = {v.leaf for s in prog.stmts for v in s.args if v.leaf}
    if out_var.leaf:
        used.add(out_var.leaf)
    uses_out = any(l.startswith(("osrc:", "oedge:")) for l in used)
    uses_in = any(l.startswith(("src:", "edge:")) for l in used)
    if uses_out and uses_in:
        raise NotImplementedError(
            "a vertex program may aggregate over in-edges or out-edges, "
            "not both (split it into two compiled programs)"
        )

    def fn(gv: GraphView, n_feats: Dict[str, Any], e_feats: Dict[str, Any]):
        if isinstance(gv, CSR):
            gv = GraphView(csr=gv)
        if uses_out:
            # Flip the view: the transpose CSR becomes the forward graph.
            csr_t = gv.csr_t if gv.csr_t is not None else gv.csr.transpose()
            gv = GraphView(csr=csr_t, csr_t=gv.csr)
        csr = gv.csr
        env: Dict[int, Any] = {}
        edge_env: Dict[int, Any] = {}  # per-var cache of edge-domain tensors

        def bind_leaf(v: Var) -> Any:
            kind, _, name = v.leaf.partition(":")
            if kind in ("src", "dst", "osrc"):
                return n_feats[name]
            if kind in ("edge", "oedge"):
                e = _pad_edges(e_feats[name], csr.capacity)
                return M.edge_data_to_csr_order(csr, e)
            if kind == "param":
                return _param(param_values[v.leaf], csr.device)
            raise KeyError(v.leaf)

        def node_val(v: Var) -> Any:
            if v.id not in env:
                if v.leaf is None:
                    raise RuntimeError(f"unmaterialized var {v}")
                env[v.id] = bind_leaf(v)
            return env[v.id]

        def as_edge(v: Var) -> Any:
            if v.val_type == ValType.EDGE:
                return node_val(v)
            if v.id in edge_env:
                return edge_env[v.id]
            arr = node_val(v)
            if v.val_type == ValType.SRC:
                arr = M.gather_src(csr, arr)
            elif v.val_type == ValType.DEST:
                arr = M.gather_dst(csr, arr)
            # PARAM: broadcasts as-is.
            edge_env[v.id] = arr
            return arr

        for stmt in prog.stmts:
            if stmt.op.startswith("Agg"):
                val = _lower_agg(stmt, gv, as_edge, node_val, impl)
            elif stmt.ret.val_type == ValType.EDGE:
                val = stmt.fn(*[as_edge(a) for a in stmt.args], **stmt.kwargs)
            else:
                val = stmt.fn(*[node_val(a) for a in stmt.args], **stmt.kwargs)
            env[stmt.ret.id] = val

        return node_val(out_var)

    return fn


def _param(value: Any, device: torch.device) -> Any:
    """A captured parameter as the lowered program uses it: tensors and
    arrays on the graph's device, Python scalars as they are."""
    if torch.is_tensor(value):
        return value.to(device)
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, device=device)
    return value


def _pad_edges(e: torch.Tensor, capacity: int) -> torch.Tensor:
    """Pad user-order edge data to CSR capacity with zeros."""
    if e.shape[0] == capacity:
        return e
    pad = e.new_zeros((capacity - e.shape[0],) + tuple(e.shape[1:]))
    return torch.cat([e, pad], dim=0)


def _mul_chain_factors(v: Var) -> List[Var]:
    """Flatten a Mul tree rooted at ``v`` into its leaf factors."""
    stmt = v.producer
    if stmt is not None and stmt.op == "Mul":
        out: List[Var] = []
        for a in stmt.args:
            out.extend(_mul_chain_factors(a))
        return out
    return [v]


def _lower_agg(
    stmt: Stmt,
    gv: GraphView,
    as_edge: Callable,
    node_val: Callable,
    impl: str,
):
    csr = gv.csr
    (arg,) = stmt.args
    reduce = stmt.kwargs["reduce"]

    if reduce == "sum":
        factors = _mul_chain_factors(arg)
        wide = [
            f
            for f in factors
            if f.val_type == ValType.SRC and len(f.shape) >= 1 and f.shape[-1] > 1
        ]
        wide_ids = {f.id for f in wide}
        narrow = [f for f in factors if f.id not in wide_ids]
        narrow_ok = all(
            f.val_type == ValType.PARAM or len(f.shape) == 0 or f.shape[-1] == 1
            for f in narrow
        )
        if len(wide) == 1 and narrow_ok:
            feat = node_val(wide[0])
            w = None
            for f in narrow:
                fe = as_edge(f)
                w = fe if w is None else w * fe
            return M.spmm(csr, feat, edge_weight=w, reduce="sum", impl=impl)

    return M.aggregate(csr, as_edge(arg), reduce=reduce, masked=True)
