"""GAT's composed route, rowmask branch, against the JAX package on the same
numpy inputs: K5's and the no-gather sum's plain versions against
``segment_max_wide``/``segment_sum_wide`` in interpret mode (values and
gradients), K1's heads and denominator modes and K2's heads mode against
``spmm_rowmask``/``spmm_rowmask_bwd(heads=h)`` in interpret mode,
``RowmaskGat`` and its three gradients against JAX's
``sparse_gat_attention(interpret=True)``, the composed route past 16 heads,
the multi-head SpMM's gradients, a two-layer 32 x 4 -> 1 x 3 GAT with one
Adam step against optax, and attention dropout's routes.

Tolerances: K5 is a maximum, exact in both packages: bit-equal, gradients
(an argmax mask) too. The no-gather sum, K1 and K2 do the JAX kernels'
arithmetic (a bf16 stream rounds the same values, weights and products
to bf16 in both) with f32 sums in another order; the port's plain
versions sum in f64: 2e-4 relative and absolute, as the K3 and K10 tests.
Attention outputs and the models: 1e-4 relative and 1e-5 absolute, the
same f32 arithmetic in another order. Gradients: 2e-3, as for the flash
and blocked routes (``tests/test_torch_composed_gat.py``): the softmax
backward's cancelling terms (``dw - c``) lose more digits than the forward.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.graph.static_graph import StaticGraph as JaxStaticGraph
from stgraph_tpu.nn.gat_conv import GATConv as JaxGATConv
from stgraph_tpu.ops import attention as JA
from stgraph_tpu.ops import segment_pallas as NSP
from stgraph_tpu.ops import spmm_pallas
from stgraph_tpu_torch.convert import gat_params_from_jax
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import GATConv
from stgraph_tpu_torch.nn.gat_conv import attention_dropout_seed
from stgraph_tpu_torch.ops import attention as A
from stgraph_tpu_torch.ops import flash_gat as FG
from stgraph_tpu_torch.ops import message as M
from stgraph_tpu_torch.ops import segment_kernels as SK
from stgraph_tpu_torch.ops import spmm_cuda
from stgraph_tpu_torch.ops import spmm_kernels as K
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=2e-4, atol=2e-4)
GRAD = dict(rtol=2e-3, atol=2e-3)
MODEL = dict(rtol=1e-4, atol=1e-5)

# (H, F) the row-wise kernel's heads modes take: a lane a head (32 x 4), a
# head over 8 lanes (4 x 32), two heads in a lane (64 x 2), one wide head
HEAD_TILINGS = [(32, 4), (4, 32), (64, 2), (1, 200)]
STREAMS = [None, "bf16"]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _value_and_vjp(fn, g, *args):
    """``fn(*args)`` and the gradients of ``sum(fn(*args) * g)`` by every
    argument, from one compiled program (a forward and a gradient compiled
    apart would trace and compile the forward twice)."""

    @jax.jit
    def both(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(jnp.asarray(g, out.dtype))

    return both(*args)


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


def _pair(rng, n=300, e=3000, capacity=None):
    src, dst = _edges(rng, n, e)
    return (build_csr(src, dst, n, capacity=capacity, device="cpu"),
            jax_build_csr(src, dst, n, capacity=capacity), n)


def _streams(stream):
    return (None, None) if stream is None else (torch.bfloat16, jnp.bfloat16)


@pytest.fixture
def bf16_stream_graph(rng):
    """A graph of 200,000 edges, so both packages' no-gather sums stream
    bf16. The JAX package's threshold is a literal (``segment_pallas.py:684``)
    and its kernel pads the plane only as far as the real edges reach
    (``row_block_meta``'s ``cap_pad``), so the graph itself has to hold that
    many edges."""
    return _pair(rng, e=SK.WIDE_BF16_MIN_SLOTS)


# -- K5 -------------------------------------------------------------------------


@pytest.mark.parametrize("k", [17, 32, 130])
def test_k5_plain_matches_pallas_interpret_bit_for_bit(rng, k):
    csr, jcsr, n = _pair(rng)
    vals = rng.standard_normal((csr.capacity, k)).astype(np.float32)
    ref = jax.jit(lambda v: NSP.segment_max_wide(jcsr, v, interpret=True))(jnp.asarray(vals))
    out = SK.segment_max_wide(csr, _t(vals))
    np.testing.assert_array_equal(out.numpy(), _np(ref))
    np.testing.assert_array_equal(out.numpy()[n - 3:], 0.0)  # empty rows


def test_k5_gradient_with_ties_matches_jax(rng):
    csr, jcsr, n = _pair(rng)
    vals = rng.integers(-3, 4, (csr.capacity, 20)).astype(np.float32)  # many ties a row
    g = rng.standard_normal((n, 20)).astype(np.float32)
    ref = jax.jit(jax.grad(lambda v: jnp.sum(NSP.segment_max_wide(jcsr, v, interpret=True) * g)))(jnp.asarray(vals))
    v = _t(vals).requires_grad_()
    (SK.SegmentMaxWide.apply(v, csr) * _t(g)).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), _np(ref))
    e = csr.num_edges
    rows_with_edges = int((np.diff(csr.host_arrays()[0]) > 0).sum())
    assert (v.grad[:e] != 0).sum().item() > rows_with_edges * 20  # ties double-count
    assert not v.grad[e:].any()  # padding gets nothing


# -- K1's no-gather mode --------------------------------------------------------


@pytest.mark.parametrize("k", [17, 32])
def test_wide_sum_plain_matches_pallas_interpret_f32(rng, k):
    csr, jcsr, n = _pair(rng)
    vals = rng.standard_normal((csr.capacity, k)).astype(np.float32)
    assert not SK.wide_stream_is_bf16(csr, _t(vals))
    ref = jax.jit(lambda v: NSP.segment_sum_wide(jcsr, v, interpret=True))(jnp.asarray(vals))
    out = SK.segment_sum_wide(csr, _t(vals))
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)
    np.testing.assert_array_equal(out.numpy()[n - 3:], 0.0)


@pytest.mark.parametrize("k", [17, 32])
def test_wide_sum_plain_matches_pallas_interpret_bf16_stream(bf16_stream_graph, rng, k):
    csr, jcsr, n = bf16_stream_graph
    vals = rng.standard_normal((csr.capacity, k)).astype(np.float32)
    assert SK.wide_stream_is_bf16(csr, _t(vals))
    ref = jax.jit(lambda v: NSP.segment_sum_wide(jcsr, v, interpret=True))(jnp.asarray(vals))
    out = SK.segment_sum_wide(csr, _t(vals))
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)
    # the values were rounded: the f32 sums differ
    e = csr.num_edges
    exact = torch.zeros(n, k, dtype=torch.float64).index_add_(0, csr.rows[:e].long(), _t(vals[:e]).double())
    assert not torch.allclose(out.double(), exact, rtol=1e-6, atol=1e-6)


def test_wide_sum_gradient_matches_jax(rng):
    csr, jcsr, n = _pair(rng)
    vals = rng.standard_normal((csr.capacity, 24)).astype(np.float32)
    g = rng.standard_normal((n, 24)).astype(np.float32)
    ref = jax.jit(jax.grad(lambda v: jnp.sum(NSP.segment_sum_wide(jcsr, v, interpret=True) * g)))(jnp.asarray(vals))
    v = _t(vals).requires_grad_()
    (SK.SegmentSumWide.apply(v, csr) * _t(g)).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), _np(ref))


# -- K1's heads and denominator modes, K2's heads mode ------------------------


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("h,f", HEAD_TILINGS)
def test_k1_heads_and_denominator_match_pallas_interpret(rng, h, f, stream):
    csr, jcsr, n = _pair(rng)
    tdt, jdt = _streams(stream)
    x = rng.standard_normal((n, h * f)).astype(np.float32)
    w = rng.random((csr.capacity, h)).astype(np.float32)
    ref, ref_den = jax.jit(lambda a, b: NSP.spmm_rowmask(jcsr, b, a, heads=h, with_denom=True, interpret=True,
                                                         stream_dtype=jdt))(jnp.asarray(x), jnp.asarray(w))
    out, den = K.spmm_rowmask(csr, _t(w), _t(x), heads=h, with_denom=True, stream_dtype=tdt)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)
    np.testing.assert_allclose(den.numpy(), _np(ref_den), **F32)
    assert not out[n - 3:].any() and not den[n - 3:].any()
    # without the denominator: the same sums, and no denominator
    alone, none = K.spmm_rowmask(csr, _t(w), _t(x), heads=h, stream_dtype=tdt)
    assert none is None and torch.equal(alone, out)


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("h,f", HEAD_TILINGS)
def test_k2_heads_matches_pallas_interpret(rng, h, f, stream):
    csr, jcsr, n = _pair(rng)
    csr_t, jcsr_t = csr.transpose(), jcsr.transpose()
    tdt, jdt = _streams(stream)
    g = rng.standard_normal((n, h * f)).astype(np.float32)
    fs = rng.standard_normal((n, h * f)).astype(np.float32)
    w = rng.random((csr.capacity, h)).astype(np.float32)
    ref_dh, ref_dw = jax.jit(lambda a, b, c: NSP.spmm_rowmask_bwd(jcsr_t, b, a, c, heads=h, interpret=True,
                                                                 stream_dtype=jdt))(
        jnp.asarray(g), jnp.asarray(w), jnp.asarray(fs))
    dh, dw = K.spmm_rowmask_bwd(csr_t, _t(w), _t(g), _t(fs), stream_dtype=tdt, heads=h)
    e = csr.num_edges
    assert dw.shape == ((csr.capacity,) if h == 1 else (csr.capacity, h))
    np.testing.assert_allclose(dh.numpy(), _np(ref_dh), **F32)
    np.testing.assert_allclose(dw.numpy().reshape(-1, h)[:e], _np(ref_dw)[:e], **F32)
    assert not dw[e:].any()  # padding slots


def test_k1_and_k2_refuse_what_the_jax_kernels_refuse(rng):
    csr, jcsr, n = _pair(rng)
    x = torch.zeros(n, 200)
    w = torch.ones(csr.capacity, 2)
    with pytest.raises(ValueError, match="128 % F"):  # F = 100: 128 % F != 0
        K.spmm_rowmask(csr, w, x, heads=2)
    with pytest.raises(ValueError, match="128 % F"):
        K.spmm_rowmask_bwd(csr.transpose(), w, x, x, heads=2)
    with pytest.raises(ValueError):
        NSP.spmm_rowmask(jcsr, jnp.ones((csr.capacity, 2)), jnp.zeros((n, 200)), heads=2, interpret=True)
    with pytest.raises(ValueError, match="requires weights"):
        K.spmm_rowmask(csr, None, torch.zeros(n, 128), with_denom=True)


def test_multihead_spmm_gradients_match_jax(rng):
    """``spmm`` at a rowmask tiling: K1's heads mode forward, K2's in
    backward (their plain versions inside ``_RowmaskSpmm`` on the CPU),
    against ``jax.grad`` of ``spmm_pallas.spmm(interpret=True)``."""
    csr, jcsr, n = _pair(rng)
    h, f = 32, 4
    x = rng.standard_normal((n, h, f)).astype(np.float32)
    w = rng.random((csr.capacity, h)).astype(np.float32)
    g = rng.standard_normal((n, h, f)).astype(np.float32)

    ref, (rx, rw) = _value_and_vjp(lambda a, b: spmm_pallas.spmm(jcsr, a, b, interpret=True), g,
                                   jnp.asarray(x), jnp.asarray(w))
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    out = spmm_cuda.spmm(csr, xt, wt)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(ref), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), _np(rx), **GRAD)
    e = csr.num_edges
    np.testing.assert_allclose(wt.grad.numpy()[:e], _np(rw)[:e], **GRAD)
    assert not wt.grad[e:].any()


# -- the attention ---------------------------------------------------------------


@pytest.mark.parametrize("h,f", [(32, 4), (4, 128)])
def test_rowmask_gat_and_its_gradients_match_jax(rng, monkeypatch, h, f):
    calls = []
    apply = A.RowmaskGat.apply
    monkeypatch.setattr(A.RowmaskGat, "apply", lambda *a: calls.append(a[2].shape[1:]) or apply(*a))
    csr, jcsr, n = _pair(rng)
    el = rng.standard_normal((n, h)).astype(np.float32)
    er = rng.standard_normal((n, h)).astype(np.float32)
    fs = rng.standard_normal((n, h, f)).astype(np.float32)
    g = rng.standard_normal((n, h, f)).astype(np.float32)

    def jax_attn(a, b, c):
        return JA.sparse_gat_attention(jcsr, a[..., None], b[..., None], c, interpret=True)

    ref, refs = _value_and_vjp(jax_attn, g, el, er, fs)
    ts = [_t(v).requires_grad_() for v in (el, er, fs)]
    out = A.sparse_gat_attention(csr, ts[0][..., None], ts[1][..., None], ts[2])
    (out * _t(g)).sum().backward()
    assert calls == [(h, f)]  # the rowmask branch, not flash, not the blocked kernel
    np.testing.assert_allclose(out.detach().numpy(), _np(ref), **MODEL)
    assert not out[n - 3:].any()  # rows without edges: exactly 0
    for name, t, r in zip(("d el", "d er", "d feat"), ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), err_msg=name, **GRAD)


def test_composed_route_past_16_heads_takes_the_wide_kernels(rng, monkeypatch):
    """17 x 8 is no rowmask tiling: the blocked route, whose stability max
    and segment sums past 16 heads are K5 and the no-gather sum."""
    calls = []
    for name in ("segment_max_wide", "segment_sum_wide"):
        fn = getattr(A, name)
        monkeypatch.setattr(A, name, lambda c, v, fn=fn, name=name: calls.append(name) or fn(c, v))
    csr, jcsr, n = _pair(rng)
    h, f = 17, 8
    el = rng.standard_normal((n, h)).astype(np.float32)
    er = rng.standard_normal((n, h)).astype(np.float32)
    fs = rng.standard_normal((n, h, f)).astype(np.float32)
    g = rng.standard_normal((n, h, f)).astype(np.float32)

    def jax_attn(a, b, c):
        return JA.sparse_gat_attention(jcsr, a[..., None], b[..., None], c, interpret=True)

    ref, refs = _value_and_vjp(jax_attn, g, el, er, fs)
    ts = [_t(v).requires_grad_() for v in (el, er, fs)]
    out = A.sparse_gat_attention(csr, ts[0][..., None], ts[1][..., None], ts[2])
    (out * _t(g)).sum().backward()
    # forward: the max and the denominator; backward: d er and d el
    assert calls == ["segment_max_wide", "segment_sum_wide", "segment_sum_wide", "segment_sum_wide"]
    np.testing.assert_allclose(out.detach().numpy(), _np(ref), **MODEL)
    for name, t, r in zip(("d el", "d er", "d feat"), ts, refs):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), err_msg=name, **GRAD)


# -- the driver's model: 32 x 4 -> 1 x 3 ------------------------------------------


class _JaxGAT(fnn.Module):
    """benchmarking/gat/train.py's two-layer stack."""

    graph: object
    hidden: int
    heads: int
    classes: int

    @fnn.compact
    def __call__(self, h):
        h = JaxGATConv(h.shape[-1], self.hidden, num_heads=self.heads, activation=jax.nn.elu,
                       impl="sparse")(self.graph, h)
        h = h.reshape(h.shape[0], -1)
        return JaxGATConv(h.shape[-1], self.classes, num_heads=1, impl="sparse")(self.graph, h).mean(1)


class _GAT(torch.nn.Module):
    def __init__(self, graph, fin, hidden, heads, classes):
        super().__init__()
        self.graph = graph
        self.layers = torch.nn.ModuleList([
            GATConv(fin, hidden, heads, activation=torch.nn.functional.elu, impl="sparse", device="cpu"),
            GATConv(hidden * heads, classes, 1, impl="sparse", device="cpu"),
        ])

    def forward(self, h):
        h = self.layers[0](self.graph, h).reshape(h.shape[0], -1)
        return self.layers[1](self.graph, h).mean(1)


def test_two_layer_rowmask_gat_and_an_adam_step_match_optax(rng, monkeypatch):
    routes = []
    for name in ("RowmaskGat", "ComposedGat"):
        cls = getattr(A, name)
        apply = cls.apply
        monkeypatch.setattr(cls, "apply", lambda *a, apply=apply, name=name: routes.append(name) or apply(*a))
    monkeypatch.setattr(A, "flash_gat_attention",
                        lambda *a, fn=A.flash_gat_attention: routes.append("flash") or fn(*a))
    n, fin, hidden, heads, classes = 300, 20, 4, 32, 3
    src, dst = _edges(rng, n)
    edges = np.stack([src, dst], 1)
    g, jg = StaticGraph(edges, None, n, device="cpu"), JaxStaticGraph(edges, None, n)
    x = rng.standard_normal((n, fin)).astype(np.float32)
    y = rng.integers(0, classes, n)
    jmodel = _JaxGAT(jg, hidden, heads, classes)
    params = jax.jit(jmodel.init)(jax.random.key(3), jnp.asarray(x))
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
    model = _GAT(g, fin, hidden, heads, classes)
    model.load_state_dict(gat_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    topt = torch.optim.Adam(model.parameters(), lr=5e-3)
    logits = model(_t(x))
    loss = torch.nn.functional.cross_entropy(logits, _t(y))
    loss.backward()
    assert routes == ["RowmaskGat", "flash"]  # 32 x 4 on the rowmask branch, 1 x 3 on the flash route
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits), **MODEL)
    np.testing.assert_allclose(loss.item(), float(jloss), **MODEL)
    ref = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **GRAD)
    topt.step()
    # Adam's first step moves each parameter by about lr sign(g); where
    # |g| >= 1e-6 a gradient error dg moves it by at most lr eps dg / g^2,
    # and the stepped parameters are held to MODEL there
    # (tests/test_torch_composed_gat.py gives the derivation).
    final = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, new_params))
    for k, v in model.state_dict().items():
        firm = np.abs(ref[k].numpy()) >= 1e-6
        np.testing.assert_allclose(v.numpy()[firm], final[k].numpy()[firm], err_msg=k, **MODEL)
        assert np.abs(v.numpy() - final[k].numpy()).max() <= 2 * 5e-3, k


# -- attention dropout ------------------------------------------------------------


@pytest.mark.parametrize("h,f", [(8, 8), (8, 32), (2, 100), (32, 4)])
def test_attention_dropout_takes_the_reference_routes(rng, monkeypatch, h, f):
    """The JAX layer trains with dropout on its flash kernels at its flash
    tilings and on its edge-domain route elsewhere. The port routes by the
    tiling alone, the CPU as a card: at the reference's flash tilings that
    its own flash kernels take (8 x 32) the flash route with K8's and K9's
    dropout mode, whose hash mask the edge-domain route reproduces; off
    them the edge-domain route with ``torch.rand``. Nothing raises."""
    src, dst = _edges(rng, 300, 3000)
    g = StaticGraph(np.stack([src, dst], 1), None, 300, device="cpu")
    x = _t(rng.standard_normal((300, 12)).astype(np.float32))
    conv = GATConv(12, f, h, attn_drop=0.5, impl="sparse", device="cpu",
                   generator=torch.Generator().manual_seed(1)).train()
    out = conv(g, x, generator=torch.Generator().manual_seed(2))
    out.sum().backward()
    assert out.shape == (300, h, f) and all(torch.isfinite(p.grad).all() for p in conv.parameters())
    flash = FG.reference_flash_tiling(h, f)
    assert flash == ((h, f) == (8, 32)) and (not flash or FG.flash_supported(h, f))
    # the same keep mask through the edge-domain route itself: the hash of
    # the seed a twin generator draws at the flash tiling, else torch.rand
    with torch.no_grad():
        fsrc = conv.fc(x).reshape(-1, h, f)
        el = (fsrc * conv.attn_l).sum(-1, keepdim=True)
        er = (fsrc * conv.attn_r).sum(-1, keepdim=True)
        twin = torch.Generator().manual_seed(2)
        csr = g.fwd_csr
        if flash:
            seed = attention_dropout_seed(twin, "cpu")
            keep = FG.edge_keep_mask(csr.cols, csr.rows, seed, h, 0.5)
            ref = A.composed_gat_attention_dropout(csr, el, er, fsrc, 0.2, 0.5, keep=keep)
        else:
            ref = A.composed_gat_attention_dropout(csr, el, er, fsrc, 0.2, 0.5, twin)
    torch.testing.assert_close(out.detach(), ref, **(MODEL if flash else {}))
    # on a card: routed by the reference's flash predicate alone
    reached = []
    monkeypatch.setattr(A, "composed_gat_attention_dropout",
                        lambda csr, el, er, fs, *a, **k: reached.append(("edge", fs.shape[1:])) or fs)
    monkeypatch.setattr(A, "flash_gat_attention",
                        lambda csr, el, er, fs, hh, slope, sdt, rate, seed: reached.append(("flash", rate)) or fs)
    card = GATConv(12, f, h, attn_drop=0.5, impl="sparse", device="meta").train()
    assert card(g, torch.empty(300, 12, device="meta")).shape == (300, h, f)
    assert reached == ([("flash", 0.5)] if flash else [("edge", (h, f))])
