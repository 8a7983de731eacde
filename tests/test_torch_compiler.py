"""The port's vertex compiler against the JAX lowering: the formulas of
``tests/test_compiler.py`` run through both ``STGraph().compile``s on the
same numpy inputs, forward values and gradients (torch autograd against
``jax.grad``).

Tolerance 1e-5 relative and absolute: the same f32 arithmetic with sums in
another order (the dense path adds an f32 matmul's blocking order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stgraph_tpu.compiler as JC
import stgraph_tpu_torch.compiler as PC
from stgraph_tpu.graph.static_graph import StaticGraph as JaxStaticGraph
from stgraph_tpu_torch.compiler.ir import ValType
from stgraph_tpu_torch.graph.static_graph import StaticGraph

TOL = dict(rtol=1e-5, atol=1e-5)


def gcn(dsl):
    return lambda v: sum([nb.h * nb.norm for nb in v.innbs]) * v.norm


def weighted_gcn(dsl):
    return lambda v: sum([eg.src.norm * eg.src.h * eg.edge_weight for eg in v.inedges]) * v.norm


def gat(dsl):
    def f(v):
        embs = [dsl.leaky_relu(nb.el + v.er, negative_slope=0.2) for nb in v.innbs]
        m = dsl.agg_max(embs)
        coeff = [dsl.exp(emb - m) for emb in embs]
        s = dsl.agg_sum(coeff)
        alpha = [c / s for c in coeff]
        fs = [nb.feat_src for nb in v.innbs]
        return sum([alpha[i] * fs[i] for i in range(len(fs))])

    return f


def mean(dsl):
    return lambda v: dsl.agg_mean([nb.h for nb in v.innbs])


def scaled(dsl):
    return lambda v: sum([nb.h * 2.5 for nb in v.innbs])


def elementwise(dsl):
    def f(v):
        e = [dsl.tanh(nb.h) * dsl.sigmoid(v.h) + dsl.clamp(nb.h - v.h, min=-0.5, max=0.5) for nb in v.innbs]
        m = dsl.agg_min([dsl.relu(x) - x.abs() for x in e])
        return dsl.sqrt(dsl.exp(m) + 1.0) * (v.norm**2) - dsl.log(v.norm + 2.0) + (-m).sum(keepdims=True)

    return f


def out_sum(dsl):
    return lambda v: sum([nb.h for nb in v.outnbs])


FORMULAS = [gcn, weighted_gcn, gat, mean, scaled, elementwise, out_sum]


@pytest.fixture
def graphs(rng):
    n, e = 40, 157  # capacity 160: three padding edges
    src = rng.integers(0, n - 4, e)  # 4 isolated nodes
    dst = rng.integers(0, n - 4, e)
    edges = np.stack([src, dst], 1)
    return StaticGraph(edges, None, n, device="cpu"), JaxStaticGraph(edges, None, n), n, e


def _inputs(rng, n, e):
    return {
        "h": rng.standard_normal((n, 8)).astype(np.float32),
        "norm": (rng.random((n, 1)) + 0.5).astype(np.float32),
        "el": rng.standard_normal((n, 4, 1)).astype(np.float32),
        "er": rng.standard_normal((n, 4, 1)).astype(np.float32),
        "feat_src": rng.standard_normal((n, 4, 8)).astype(np.float32),
    }, {"edge_weight": rng.random((e, 1)).astype(np.float32)}


def _feeds(formula, nf, ef):
    if formula is gat:
        return {k: nf[k] for k in ("el", "er", "feat_src")}, {}
    if formula is weighted_gcn:
        return {k: nf[k] for k in ("h", "norm")}, ef
    if formula in (gcn, elementwise):
        return {k: nf[k] for k in ("h", "norm")}, {}
    return {"h": nf["h"]}, {}


@pytest.mark.parametrize("formula", FORMULAS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("impl,jimpl", [("torch", "jnp"), ("dense", "dense"), ("kernel", "jnp")])
def test_formula_and_grads_match_jax(graphs, rng, formula, impl, jimpl):
    g, jg, n, e = graphs
    nf, ef = _feeds(formula, *_inputs(rng, n, e))
    port_prog = PC.STGraph().compile(impl=impl)(formula(PC.dsl))
    jax_prog = JC.STGraph().compile(impl=jimpl)(formula(JC.dsl))

    tn = {k: torch.from_numpy(v).requires_grad_() for k, v in nf.items()}
    te = {k: torch.from_numpy(v).requires_grad_() for k, v in ef.items()}
    out = port_prog(g, n_feats=tn, e_feats=te)
    # jit, as the JAX package runs: its eager jnp path indexes host numpy
    # with the padding sentinel
    run = jax.jit(lambda nd, ed: jax_prog(jg, n_feats=nd, e_feats=ed))
    ref = run({k: jnp.asarray(v) for k, v in nf.items()}, {k: jnp.asarray(v) for k, v in ef.items()})
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)

    cot = rng.standard_normal(tuple(out.shape)).astype(np.float32)
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(nd, ed):
        return (run(nd, ed) * cot).sum()

    jn, je = jax.grad(loss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in nf.items()}, {k: jnp.asarray(v) for k, v in ef.items()}
    )
    for k in nf:
        np.testing.assert_allclose(tn[k].grad.numpy(), np.asarray(jn[k]), **TOL)
    for k in ef:
        np.testing.assert_allclose(te[k].grad.numpy(), np.asarray(je[k]), **TOL)


def test_trace_matches_jax_trace():
    spec = {"h": ((8,), torch.float32), "norm": ((1,), torch.float32)}
    jspec = {"h": ((8,), np.float32), "norm": ((1,), np.float32)}
    tr = PC.trace(gcn(PC.dsl), spec, {})
    jtr = JC.trace(gcn(JC.dsl), jspec, {})
    assert [s.op for s in tr.program.stmts] == [s.op for s in jtr.program.stmts] == ["Mul", "AggSum", "Mul"]
    assert tr.output.val_type == ValType.DEST
    # bf16 specs trace too (numpy has no bf16; the probes are torch tensors)
    tr16 = PC.trace(gcn(PC.dsl), {"h": ((8,), torch.bfloat16), "norm": ((1,), torch.bfloat16)}, {})
    assert tr16.output.dtype == torch.bfloat16


def test_cse_dce_and_guards():
    def f(v):
        a = [nb.h * nb.norm for nb in v.innbs][0]
        b = [nb.h * nb.norm for nb in v.innbs][0]
        _unused = v.h * 3.0
        return PC.dsl.agg_sum([a + b])

    tr = PC.trace(f, {"h": ((8,), torch.float32), "norm": ((1,), torch.float32)}, {})
    assert [s.op for s in tr.program.stmts] == ["Mul", "Add", "AggSum"]
    with pytest.raises(TypeError):
        PC.trace(lambda v: [x for x in v.h][0], {"h": ((8,), torch.float32)}, {})
    with pytest.raises(TypeError):
        PC.trace(lambda v: PC.dsl.agg_sum([v.h]), {"h": ((8,), torch.float32)}, {})


def test_mixed_direction_rejected():
    g = StaticGraph(np.array([[0, 1], [1, 2]]), None, 10, device="cpu")

    @PC.STGraph().compile()
    def mixed(v):
        return sum([nb.h for nb in v.innbs]) + sum([nb.h for nb in v.outnbs])

    with pytest.raises(NotImplementedError):
        mixed(g, n_feats={"h": torch.ones(10, 3)})


def test_debug_dump_names_the_ops():
    tr = PC.trace(gcn(PC.dsl), {"h": ((8,), torch.float32), "norm": ((1,), torch.float32)}, {})
    text = PC.debugging.dump_program(tr.program)
    assert "AggSum" in text and "Mul" in text
