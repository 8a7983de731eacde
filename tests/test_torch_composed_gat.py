"""GAT's composed route against the JAX package on the same numpy inputs: the
blocked layout, K3's and K10's plain versions against the Pallas kernels in
interpret mode, the multi-head SpMM's gradient, the composed attention's
output and gradients, ``aggregate``'s and ``spmm``'s routing, the route's
refusals on CUDA, and a three-layer GAT at composed widths with one Adam
step.

Tolerances: K3 and K10 in f32 do the JAX kernels' arithmetic with sums in
another order (the port's plain versions sum in f64): 2e-4. Outputs of the
composed attention and of the models: 1e-4 relative and 1e-5 absolute,
the same f32 arithmetic in another order. Gradients: 2e-3, as for the
flash route (``tests/test_torch_gat.py``): the hand-derived backward's
cancelling terms (``dw - c``) lose more digits than the forward.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgraph_tpu.graph.blocked import build_blocked as jax_build_blocked
from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.graph.static_graph import StaticGraph as JaxStaticGraph
from stgraph_tpu.nn.gat_conv import GATConv as JaxGATConv
from stgraph_tpu.ops import attention as JA
from stgraph_tpu.ops import segment_pallas as NSP
from stgraph_tpu.ops import spmm_pallas as SP
from stgraph_tpu_torch import native
from stgraph_tpu_torch.convert import gat_params_from_jax
from stgraph_tpu_torch.graph.blocked import build_blocked
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import GATConv
from stgraph_tpu_torch.ops import attention as A
from stgraph_tpu_torch.ops import message as M
from stgraph_tpu_torch.ops import segment_kernels as SK
from stgraph_tpu_torch.ops import spmm_blocked as SB
from stgraph_tpu_torch.ops import spmm_cuda

F32 = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=2e-3, atol=2e-3)
MODEL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _edges(rng, n=300, e=3000):
    """A heavy duplicate edge, isolated destinations (the last three nodes)
    and N not a multiple of 128."""
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[: e // 10] = src[0]
    dst[: e // 10] = dst[0]
    dst = np.where(dst >= n - 3, 0, dst)
    return src, dst


def _pair(rng, n=300, e=3000):
    src, dst = _edges(rng, n, e)
    return build_csr(src, dst, n, device="cpu"), jax_build_csr(src, dst, n), n


# -- the blocked layout -------------------------------------------------------


def _layout_graph(rng, case):
    if case == "test_pallas":  # tests/test_pallas.py's graph
        n, e = 300, 2000
        return rng.integers(0, n, e), rng.integers(0, n, e), n
    if case == "ragged":  # N not a multiple of 128, an empty block, empty rows
        n, e = 1000, 5000
        dst = rng.integers(0, n, e)
        dst = np.where((dst >= 256) & (dst < 384), 0, dst)
        return rng.integers(0, n, e), dst, n
    n, e = 700, 6000  # "hub": one 128-row block holds over 1024 edges
    dst = rng.integers(0, n, e)
    dst[:2500] = 130
    return rng.integers(0, n, e), dst, n


@pytest.mark.parametrize("builder", ["native", "numpy"])
@pytest.mark.parametrize("case", ["test_pallas", "ragged", "hub"])
def test_build_blocked_matches_jax(rng, monkeypatch, case, builder):
    src, dst, n = _layout_graph(rng, case)
    if builder == "numpy":
        monkeypatch.setattr(native, "build_blocked_arrays", lambda *a: None)
    port = build_blocked(build_csr(src, dst, n, device="cpu"))
    ref = jax_build_blocked(jax_build_csr(src, dst, n))
    for name in ("offsets", "counts", "dst", "cols", "perm", "eids"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name)
    assert (port.num_nodes, port.num_rows_padded, port.csr_capacity) == (
        ref.num_nodes, ref.num_rows_padded, ref.csr_capacity)
    if case == "hub":
        assert port.counts.max().item() > 1024


def test_static_graph_blocked_layouts_are_built_once(rng):
    src, dst = _edges(rng)
    g = StaticGraph(np.stack([src, dst], 1), None, 300, device="cpu")
    jg = JaxStaticGraph(np.stack([src, dst], 1), None, 300)
    assert g.blocked_fwd is g.blocked_fwd and g.blocked_bwd is g.blocked_bwd
    np.testing.assert_array_equal(g.blocked_bwd.eids.numpy(), np.asarray(jg.blocked_bwd.eids))


# -- K3 -------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 6, 16])
def test_k3_plain_matches_pallas_interpret(rng, k):
    csr, jcsr, n = _pair(rng)
    vals = rng.standard_normal((csr.capacity, k)).astype(np.float32)
    g = rng.standard_normal((n, k)).astype(np.float32)
    out = SK.segment_sum_narrow(csr, _t(vals))
    ref = jax.jit(lambda v: NSP.segment_sum_narrow(jcsr, v, interpret=True))(vals)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)
    np.testing.assert_array_equal(out.numpy()[n - 3:], 0.0)  # empty rows
    # the VJP is the destination gather, 0 on padding slots
    ref_grad = jax.jit(jax.grad(lambda v: jnp.sum(NSP.segment_sum_narrow(jcsr, v, interpret=True) * g)))(vals)
    v = _t(vals).requires_grad_()
    (SK.SegmentSumNarrow.apply(v, csr) * _t(g)).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), _np(ref_grad))
    assert torch.equal(SK.segment_sum_narrow_plain(csr, _t(vals), edge_block=97), out)


# -- K10 and the multi-head SpMM ----------------------------------------------


@pytest.mark.parametrize("h,f", [(3, 20), (2, 130)])
def test_k10_plain_matches_pallas_interpret(rng, h, f):
    """JAX's kernel is fed its own gathered and scaled rows, as
    ``_gather_scale_segment_sum`` feeds it; the port's plain version gathers
    itself."""
    csr, jcsr, n = _pair(rng)
    jb = jax_build_blocked(jcsr)
    blocked = build_blocked(csr)
    x = rng.standard_normal((n, h * f)).astype(np.float32)
    wb = rng.standard_normal((blocked.capacity, h)).astype(np.float32)

    def jax_k10(x, wb):
        rows = x[jnp.minimum(jnp.asarray(jb.cols), n - 1)] * jnp.repeat(wb, f, axis=1)
        return SP.segment_sum_blocked(jb, jnp.ones(jb.capacity, jnp.float32), rows, interpret=True)

    ref = jax.jit(jax_k10)(x, wb)
    out = SB.segment_sum_blocked(blocked, _t(wb), _t(x), h)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)
    np.testing.assert_array_equal(out.numpy()[n - 3:], 0.0)
    assert torch.equal(SB.segment_sum_blocked_plain(blocked, _t(wb), _t(x), h, edge_block=113), out)


@pytest.mark.parametrize("h,f", [(3, 20), (2, 130)])
def test_spmm_multihead_matches_jax_grad(rng, h, f):
    csr, jcsr, n = _pair(rng)
    jb, jbt = jax_build_blocked(jcsr), jax_build_blocked(jcsr.transpose())
    x = rng.standard_normal((n, h, f)).astype(np.float32)
    w = rng.random((csr.capacity, h)).astype(np.float32)
    g = rng.standard_normal((n, h, f)).astype(np.float32)
    fn = SP._make_spmm_multihead(jb, jbt, jcsr, interpret=True)
    ref, (dx, dw) = jax.jit(jax.value_and_grad(lambda a, b: jnp.sum(fn(a, b) * g), argnums=(0, 1)))(x, w)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = SB.spmm_multihead(csr, xt, wt)
    loss = (out * _t(g)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), _np(jax.jit(fn)(x, w)), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), _np(dx), **GRAD)
    np.testing.assert_allclose(wt.grad.numpy(), _np(dw), **GRAD)


# -- the composed attention ---------------------------------------------------


@pytest.mark.parametrize("h,f", [(4, 12), (6, 5)])
def test_composed_attention_matches_jax(rng, h, f):
    """The ``autograd.Function`` called directly: at these widths
    ``sparse_gat_attention`` would take the flash route in the port."""
    csr, jcsr, n = _pair(rng)
    jcsr_t = jcsr.transpose()
    jb, jbt = jax_build_blocked(jcsr), jax_build_blocked(jcsr_t)
    el, er = (rng.standard_normal((n, h)).astype(np.float32) * 2 for _ in range(2))
    fs = rng.standard_normal((n, h, f)).astype(np.float32)
    g = rng.standard_normal((n, h, f)).astype(np.float32)

    def jax_attn(a, b, c):
        return JA.sparse_gat_attention(jcsr, a[..., None], b[..., None], c, blocked=jb, blocked_t=jbt,
                                       csr_t=jcsr_t, interpret=True)

    ref = jax.jit(jax_attn)(el, er, fs)
    refs = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jax_attn(a, b, c) * g), argnums=(0, 1, 2)))(el, er, fs)
    csr_t = csr.transpose()
    ts = [_t(v).requires_grad_() for v in (el, er, fs)]
    out = A.ComposedGat.apply(*ts, csr, csr_t, build_blocked(csr), build_blocked(csr_t), 0.2)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(ref), **MODEL)
    assert not out[n - 3:].any()  # rows without edges: exactly 0
    for name, t, r in zip(("d el", "d er", "d feat"), ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), err_msg=name, **GRAD)


@pytest.mark.parametrize("h,f,missing", [(17, 8, "K5"), (8, 64, "K1"), (1, 384, "K1")])
def test_composed_route_on_cuda_names_the_missing_kernel(rng, monkeypatch, h, f, missing):
    """These tilings once raised on CUDA, naming the kernel each waited for.
    With K5 and K1's heads and denominator modes ported, a non-CPU tensor
    reaches that kernel: K5 for the stability max past 16 heads (17 x 8, on
    the blocked route), K1 with the tiling's heads and the denominator for
    the rowmask tilings (8 x 64, 1 x 384)."""

    class Reached(Exception):
        pass

    def reach(name):
        def kernel(*args, **kwargs):
            raise Reached(name, kwargs)

        return kernel

    monkeypatch.setattr(A, "segment_max_wide", reach("K5"))
    monkeypatch.setattr(A, "spmm_rowmask", reach("K1"))
    # K4's result, so that the rowmask branch goes on to K1
    monkeypatch.setattr(A, "segment_max_narrow", lambda c, v: torch.zeros(c.num_nodes, v.shape[1], device=v.device))
    n = 300
    csr = build_csr(*_edges(rng, n), n, device="meta")  # graph and tensors on one (non-CPU) device
    el, er = (torch.empty(n, h, 1, device="meta") for _ in range(2))
    with pytest.raises(Reached) as reached:
        A.sparse_gat_attention(csr, el, er, torch.empty(n, h, f, device="meta"))
    name, kwargs = reached.value.args
    assert name == missing
    if name == "K1":
        assert kwargs["heads"] == h and kwargs["with_denom"]


# -- routing --------------------------------------------------------------------


def test_aggregate_sum_and_mean_route_to_k3_for_a_non_cpu_tensor(rng, monkeypatch):
    e = 50_000  # the JAX package's _PALLAS_MIN_EDGES
    csr = build_csr(rng.integers(0, 500, e), rng.integers(0, 500, e), 500, device="cpu")
    calls = []

    def fake_k3(csr_, vals):
        calls.append((vals.device.type, tuple(vals.shape)))
        return torch.ones(csr_.num_nodes, vals.shape[1])  # on the CPU, so that the mean can be read

    def fake_wide(csr_, vals):
        calls.append(("wide", tuple(vals.shape)))
        return torch.ones(csr_.num_nodes, vals.shape[1])

    def torch_op(data, *a, **k):
        calls.append(("torch", tuple(data.shape)))

    monkeypatch.setattr(SK, "segment_sum_narrow", fake_k3)
    monkeypatch.setattr(SK, "segment_sum_wide", fake_wide)
    monkeypatch.setattr(M.seg, "segment_sum", torch_op)
    monkeypatch.setattr(M.seg, "segment_mean", torch_op)
    assert M.aggregate(csr, torch.empty(csr.capacity, 4, 2, device="meta")).shape == (500, 4, 2)
    mean = M.aggregate(csr, torch.empty(csr.capacity, 3, device="meta"), reduce="mean")
    assert calls == [("meta", (csr.capacity, 8)), ("meta", (csr.capacity, 3))]
    # the mean is K3's sum over max(in-degree, 1), as in the JAX package
    deg = np.diff(csr.host_arrays()[0])
    np.testing.assert_allclose(mean.numpy(), np.repeat(1.0 / np.maximum(deg, 1)[:, None], 3, 1), rtol=1e-6)
    # wide values go to K1's no-gather mode (sum and mean alike); CPU
    # tensors and small graphs keep the torch segment ops
    M.aggregate(csr, torch.zeros(csr.capacity, 8))
    M.aggregate(csr, torch.empty(csr.capacity, 17, device="meta"))
    wide_mean = M.aggregate(csr, torch.empty(csr.capacity, 17, device="meta"), reduce="mean")
    np.testing.assert_allclose(wide_mean.numpy(), np.repeat(1.0 / np.maximum(deg, 1)[:, None], 17, 1), rtol=1e-6)
    small = build_csr(rng.integers(0, 50, 900), rng.integers(0, 50, 900), 50, device="cpu")
    M.aggregate(small, torch.empty(small.capacity, 4, device="meta"), reduce="mean")
    assert [c[0] for c in calls] == ["meta", "meta", "torch", "wide", "wide", "torch"]


def test_multihead_spmm_routes_to_k10_or_raises(rng, monkeypatch):
    """Multi-head sums on a card: the tilings the row-wise kernel refuses go
    to K10; the others (4 x 32 here), which raised until K1's and K2's heads
    modes were ported, go to K1 with their heads."""
    e = 50_000
    csr = build_csr(rng.integers(0, 5000, e), rng.integers(0, 5000, e), 5000, device="cpu")
    calls = []
    monkeypatch.setattr(spmm_cuda, "spmm_multihead", lambda c, x, w: calls.append(tuple(x.shape)) or x)
    w = torch.empty(csr.capacity, 4, device="meta")
    M.spmm(csr, torch.empty(5000, 4, 256, device="meta"), edge_weight=w)
    M.spmm(csr, torch.empty(5000, 6, 121, device="meta"), edge_weight=torch.empty(csr.capacity, 6, device="meta"))
    assert calls == [(5000, 4, 256), (5000, 6, 121)]
    k1 = []

    def fake_k1(c, w_, x, heads=1, with_denom=False, stream_dtype=None):
        k1.append((tuple(x.shape), tuple(w_.shape), heads, with_denom))
        return torch.empty(x.shape, device=x.device), None

    monkeypatch.setattr(spmm_cuda, "spmm_rowmask", fake_k1)
    assert M.spmm(csr, torch.empty(5000, 4, 32, device="meta"), edge_weight=w).shape == (5000, 4, 32)
    assert k1 == [((5000, 128), (csr.capacity, 4), 4, False)]
    # the torch path on the CPU, where the tiling is K1's
    x = rng.standard_normal((5000, 4, 32)).astype(np.float32)
    wt = rng.random((csr.capacity, 4)).astype(np.float32)
    out = M.spmm(csr, _t(x), edge_weight=_t(wt))
    np.testing.assert_allclose(out.numpy(), M.spmm(csr, _t(x), edge_weight=_t(wt), impl="torch").numpy())
    assert len(calls) == 2 and len(k1) == 1


# -- a three-layer GAT at composed widths --------------------------------------


class _JaxGAT3(fnn.Module):
    """benchmarking/gat/train.py's stack at --num_layers 3: two GATConv(ELU)
    with concatenated heads, then GATConv with the heads averaged."""

    graph: object
    hidden: int
    heads: int
    out_heads: int
    classes: int

    @fnn.compact
    def __call__(self, h):
        for _ in range(2):
            h = JaxGATConv(h.shape[-1], self.hidden, num_heads=self.heads, activation=jax.nn.elu,
                           impl="sparse")(self.graph, h)
            h = h.reshape(h.shape[0], -1)
        return JaxGATConv(h.shape[-1], self.classes, num_heads=self.out_heads, impl="sparse")(self.graph, h).mean(1)


class _GAT3(torch.nn.Module):
    def __init__(self, graph, fin, hidden, heads, out_heads, classes):
        super().__init__()
        self.graph = graph
        elu = torch.nn.functional.elu
        self.layers = torch.nn.ModuleList([
            GATConv(fin, hidden, heads, activation=elu, impl="sparse", device="cpu"),
            GATConv(hidden * heads, hidden, heads, activation=elu, impl="sparse", device="cpu"),
            GATConv(hidden * heads, classes, out_heads, impl="sparse", device="cpu"),
        ])

    def forward(self, h):
        for layer in self.layers[:2]:
            h = layer(self.graph, h).reshape(h.shape[0], -1)
        return self.layers[2](self.graph, h).mean(1)


def test_three_layer_gat_and_an_adam_step_match_optax(rng, monkeypatch):
    calls = []
    apply = A.ComposedGat.apply
    monkeypatch.setattr(A.ComposedGat, "apply", lambda *a: calls.append(a[2].shape[1:]) or apply(*a))
    n, fin, hidden, heads, out_heads, classes = 300, 20, 100, 3, 3, 90
    src, dst = _edges(rng, n)
    edges = np.stack([src, dst], 1)
    g, jg = StaticGraph(edges, None, n, device="cpu"), JaxStaticGraph(edges, None, n)
    x = rng.standard_normal((n, fin)).astype(np.float32)
    y = rng.integers(0, classes, n)
    jmodel = _JaxGAT3(jg, hidden, heads, out_heads, classes)
    params = jax.jit(jmodel.init)(jax.random.key(7), jnp.asarray(x))
    opt = optax.adam(5e-3)

    @jax.jit
    def step(p, s):
        def loss_fn(p):
            logits = jmodel.apply(p, jnp.asarray(x))
            return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean(), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), loss, logits, grads

    new_params, jloss, jlogits, jgrads = step(params, opt.init(params))
    model = _GAT3(g, fin, hidden, heads, out_heads, classes)
    model.load_state_dict(gat_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    topt = torch.optim.Adam(model.parameters(), lr=5e-3)
    logits = model(_t(x))
    loss = torch.nn.functional.cross_entropy(logits, _t(y))
    loss.backward()
    assert calls == [(3, 100), (3, 100), (3, 90)]  # every layer took the composed route
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits), **MODEL)
    np.testing.assert_allclose(loss.item(), float(jloss), **MODEL)
    ref = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **GRAD)
    topt.step()
    # Adam's first step is p - lr g / (|g| + eps), eps = 1e-8: where
    # |g| >= 1e-6 a gradient error dg moves it by at most lr eps dg / g^2 =
    # 50 dg, and the stepped parameters are held to MODEL (over 99 % of them
    # here); nearer g = 0 the step turns the gradients' allowed error into up
    # to 2 lr.
    final = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, new_params))
    for k, v in model.state_dict().items():
        firm = np.abs(ref[k].numpy()) >= 1e-6
        np.testing.assert_allclose(v.numpy()[firm], final[k].numpy()[firm], err_msg=k, **MODEL)
        assert np.abs(v.numpy() - final[k].numpy()).max() <= 2 * 5e-3, k
