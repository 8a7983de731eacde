"""GAT's flash route and its layer against the JAX package on the same numpy
inputs: K4's, K8's and K9's plain versions (through the port's
``autograd.Function``) against the Pallas kernels in interpret mode, the
dense attention, ``GATConv``'s routes, a two-layer GAT with Adam steps,
the synthetic Pubmed and the K4 routing of ``aggregate``.

Tolerances: K4 is a maximum, exact in both packages (bit-equal). K8 in
f32 does the same arithmetic with sums in another order; 2e-4 also covers
exp's last-ulp differences between XLA and torch. With a bf16 stream the
JAX kernel reads ``el`` as a bf16 hi/lo pair (about 17 bits) where the
port reads f32, so a weight can round to the neighbouring bf16 value:
2e-2, a bf16 ulp of the largest terms. Gradients: 2e-3 (the JAX package's
own flash-gradient tolerance, ``tests/test_flash_gat.py``). Layers and
models in f32: 1e-4 relative and 1e-5 absolute, the flash and composed
routes summing in other orders.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgraph_tpu.dataset.base import STGraphDataset as JaxDataset
from stgraph_tpu.dataset.pubmed_dataloader import PubmedDataLoader as JaxPubmed
from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.graph.static_graph import StaticGraph as JaxStaticGraph
from stgraph_tpu.nn.gat_conv import GATConv as JaxGATConv
from stgraph_tpu.ops import attention as JA
from stgraph_tpu.ops import segment_pallas as NSP
from stgraph_tpu.ops import spmm_pallas
from stgraph_tpu.ops.flash_gat import flash_gat_attention as jax_flash
from stgraph_tpu_torch.convert import gat_params_from_jax
from stgraph_tpu_torch.dataset import PubmedDataLoader, STGraphDataset
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import GATConv
from stgraph_tpu_torch.ops import attention as A
from stgraph_tpu_torch.ops import flash_gat as FG
from stgraph_tpu_torch.ops import message as M
from stgraph_tpu_torch.ops import segment_kernels as SK
from stgraph_tpu_torch.ops import spmm_cuda

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=2e-3, atol=2e-3)
MODEL = dict(rtol=1e-4, atol=1e-5)

FLASH_TILINGS = [(8, 32), (1, 47), (2, 64)]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _edges(rng, n=150, e=1500):
    """tests/test_flash_gat.py's graph, smaller: a heavy duplicate edge and
    isolated destinations (the last three nodes)."""
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[: e // 10] = src[0]
    dst[: e // 10] = dst[0]
    dst = np.where(dst >= n - 3, 0, dst)
    return src, dst


def _csrs(rng, n=150, e=1500):
    src, dst = _edges(rng, n, e)
    return build_csr(src, dst, n, device="cpu"), jax_build_csr(src, dst, n), n


@pytest.fixture
def forced_bf16_stream(monkeypatch):
    """Every graph streams bf16, in both packages (the rule is a module
    constant in each)."""
    monkeypatch.setattr(spmm_pallas, "_BF16_STREAM_MIN_EDGES", 0)
    monkeypatch.setattr(spmm_cuda, "_BF16_STREAM_MIN_EDGES", 0)


# -- K4 ----------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 8, 16])
def test_k4_plain_matches_pallas_interpret_bit_for_bit(rng, k):
    csr, jcsr, n = _csrs(rng)
    vals = rng.standard_normal((csr.capacity, k)).astype(np.float32)
    ref = jax.jit(lambda v: NSP.segment_max_narrow(jcsr, v, interpret=True))(jnp.asarray(vals))
    out = SK.segment_max_narrow(csr, _t(vals))
    np.testing.assert_array_equal(out.numpy(), _np(ref))
    np.testing.assert_array_equal(out.numpy()[n - 3:], 0.0)  # empty rows
    # the index form reads a node table at cols: the same as the gathered plane
    table = rng.standard_normal((n, k)).astype(np.float32)
    plane = table[np.minimum(csr.host_arrays()[2], n - 1)]
    by_index = SK.segment_max_narrow(csr, _t(table), index=csr.cols)
    np.testing.assert_array_equal(by_index.numpy(), SK.segment_max_narrow(csr, _t(plane)).numpy())
    blocked = SK.segment_max_narrow_plain(csr, _t(table), index=csr.cols, edge_block=97)
    assert torch.equal(blocked, by_index)


def test_k4_gradient_matches_jax_with_ties(rng):
    csr, jcsr, n = _csrs(rng)
    k = 4
    vals = rng.integers(-2, 3, (csr.capacity, k)).astype(np.float32)  # many ties
    g = rng.standard_normal((n, k)).astype(np.float32)
    jv = jax.grad(lambda v: jnp.sum(NSP.segment_max_narrow(jcsr, v, interpret=True) * g))(jnp.asarray(vals))
    v = _t(vals).requires_grad_()
    (SK.SegmentMaxNarrow.apply(v, csr) * _t(g)).sum().backward()
    np.testing.assert_array_equal(v.grad.numpy(), _np(jv))
    # ties double-count: a row's edges at its maximum each take the full cotangent
    assert (np.abs(_np(jv)).sum(0) > np.abs(g).sum(0)).all()
    table = _t(rng.integers(-2, 3, (n, k)).astype(np.float32)).requires_grad_()
    (SK.SegmentMaxNarrow.apply(table, csr, csr.cols) * _t(g)).sum().backward()
    plane = table.detach()[csr.cols_clamped.long()].requires_grad_()
    (SK.SegmentMaxNarrow.apply(plane, csr) * _t(g)).sum().backward()
    want = torch.zeros(n, k).index_add_(0, csr.cols[csr.edge_mask].long(), plane.grad[csr.edge_mask])
    assert torch.equal(table.grad, want)


# -- K8 ----------------------------------------------------------------------


def _scores(rng, n, h, f, scale=1.0):
    el = (rng.standard_normal((n, h)) * scale).astype(np.float32)
    er = (rng.standard_normal((n, h)) * scale).astype(np.float32)
    fs = rng.standard_normal((n, h * f)).astype(np.float32)
    return el, er, fs


@pytest.mark.parametrize("h,f", FLASH_TILINGS)
def test_k8_plain_matches_jax_flash_f32(rng, h, f):
    csr, jcsr, n = _csrs(rng)
    el, er, fs = _scores(rng, n, h, f)
    ref = jax.jit(lambda a, b, c: jax_flash(jcsr, a, b, c, heads=h, interpret=True))(el, er, fs)
    out = FG.flash_gat_attention(csr, _t(el), _t(er), _t(fs), h)
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)
    np.testing.assert_array_equal(out.numpy()[n - 3:], 0.0)


@pytest.mark.parametrize("h,f", FLASH_TILINGS)
def test_k8_plain_matches_jax_flash_bf16_stream(rng, forced_bf16_stream, h, f):
    """Both packages decide the stream from the graph, through their
    ``sparse_gat_attention``; the fixture makes every graph stream bf16."""
    csr, jcsr, n = _csrs(rng)
    el, er, fs = _scores(rng, n, h, f, scale=3.0)
    fs3 = fs.reshape(n, h, f)
    ref = jax.jit(lambda a, b, c: JA.sparse_gat_attention(jcsr, a[..., None], b[..., None], c, interpret=True))(
        el, er, fs3
    )
    out = A.sparse_gat_attention(csr, _t(el)[..., None], _t(er)[..., None], _t(fs3))
    np.testing.assert_allclose(out.numpy(), _np(ref), **BF16)
    # and the port rounds where its plain version says: bf16 fs and weights
    f32 = FG.flash_gat_attention(csr, _t(el), _t(er), _t(fs), h)
    assert not torch.equal(out.reshape(n, -1), f32)


@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k8_aux_matches_direct_formulas(rng, stream):
    csr, _, n = _csrs(rng)
    h, f, slope = 4, 16, 0.2
    el, er, fs = _scores(rng, n, h, f)
    m = FG.stability_max(csr, _t(el), _t(er), slope)
    out, den, u, p = FG.flash_gat_fwd(csr, _t(el), _t(er), m, _t(fs), h, slope, stream, aux=True)
    out2, den2, u2, p2 = FG.flash_gat_fwd(csr, _t(el), _t(er), m, _t(fs), h, slope, stream)
    assert u2 is None and p2 is None and torch.equal(out, out2) and torch.equal(den, den2)
    e = csr.num_edges
    _, rows, cols, _ = csr.host_arrays()
    rows, cols = rows[:e], cols[:e]
    s0 = el[cols].astype(np.float64) + er[rows]
    lp = np.where(s0 >= 0, 1.0, slope)
    w = np.exp(np.minimum(np.where(s0 >= 0, s0, slope * s0) - m.numpy()[rows], 0.0))
    x = fs[cols].reshape(-1, h, f).astype(np.float64)
    ref_p = np.zeros((n, h))
    np.add.at(ref_p, rows, w * lp)
    ref_u = np.zeros((n, h, f))
    np.add.at(ref_u, rows, (w * lp)[:, :, None] * x)
    tol = BF16 if stream is not None else F32
    np.testing.assert_allclose(p.numpy(), ref_p, **F32)
    np.testing.assert_allclose(u.numpy(), ref_u.reshape(n, h * f), **tol)
    ref_den = np.zeros((n, h))
    np.add.at(ref_den, rows, w)
    np.testing.assert_allclose(den.numpy(), ref_den, **F32)


# -- K9, through the port's autograd.Function -------------------------------


@pytest.mark.parametrize("h,f", FLASH_TILINGS)
def test_flash_grads_match_jax_grad(rng, h, f):
    csr, jcsr, n = _csrs(rng)
    el, er, fs = _scores(rng, n, h, f)
    g = rng.standard_normal((n, h * f)).astype(np.float32)

    def loss(a, b, c):
        return jnp.sum(jax_flash(jcsr, a, b, c, heads=h, interpret=True) * g)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(el, er, fs)
    ts = [_t(v).requires_grad_() for v in (el, er, fs)]
    (FG.flash_gat_attention(csr, *ts, h) * _t(g)).sum().backward()
    for name, t, r in zip(("dl", "der", "dfs"), ts, ref):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), err_msg=name, **GRAD)


def test_backward_runs_k9_on_the_transpose_through_the_function(rng, monkeypatch):
    """The CPU gradient comes from the port's backward (K9's plain version
    on the transpose CSR, with the forward's aux outputs), not from autograd
    of the plain forward; a forward without a gradient skips the aux."""
    csr, _, n = _csrs(rng)
    calls = []
    fwd, bwd = FG.flash_gat_fwd, FG.flash_gat_bwd
    monkeypatch.setattr(FG, "flash_gat_fwd", lambda *a, **k: calls.append(("k8", k["aux"])) or fwd(*a, **k))
    monkeypatch.setattr(FG, "flash_gat_bwd", lambda csr_t, *a: calls.append(("k9", csr_t)) or bwd(csr_t, *a))
    el, er, fs = (_t(v) for v in _scores(rng, n, 2, 8))
    with torch.inference_mode():
        FG.flash_gat_attention(csr, el, er, fs, 2)
    fs.requires_grad_()
    FG.flash_gat_attention(csr, el, er, fs, 2).sum().backward()
    assert calls == [("k8", False), ("k8", True), ("k9", csr.transpose())]


def test_k9_plain_matches_the_autograd_of_the_composed_route(rng):
    """K9's outputs as the gradients they are: ``dfs`` and ``dl`` of a
    plain edge-domain softmax, differentiated by torch autograd."""
    csr, _, n = _csrs(rng)
    h, f, slope = 2, 8, 0.2
    el, er, fs = (_t(v).requires_grad_() for v in _scores(rng, n, h, f))
    g = _t(rng.standard_normal((n, h * f)).astype(np.float32))
    with torch.no_grad():
        m = FG.stability_max(csr, el, er, slope)
        ref, den, u, p = FG.flash_gat_fwd(csr, el, er, m, fs, h, slope, aux=True)
        gu = g / den.clamp(min=1e-38).repeat_interleave(f, 1)
        c = (g * ref).reshape(n, h, f).sum(-1) / den.clamp(min=1e-38)
        dfs, dl = FG.flash_gat_bwd(csr.transpose(), el, er, m, c, gu, fs, h, slope)
    # the composed route (torch.autograd through segment ops, m detached)
    s = M.gather_src(csr, el) + M.gather_dst(csr, er)
    s = torch.where(s >= 0, s, slope * s)
    w = torch.exp(s - M.gather_dst(csr, m)) * csr.edge_mask[:, None]
    den2 = M.aggregate(csr, w).clamp(min=1e-38)
    out2 = M.spmm(csr, fs.reshape(n, h, f), edge_weight=w, impl="torch") / den2[:, :, None]
    (out2.reshape(n, -1) * g).sum().backward()
    np.testing.assert_allclose(dfs.numpy(), fs.grad.numpy(), **GRAD)
    np.testing.assert_allclose(dl.numpy(), el.grad.numpy(), **GRAD)


# -- dense attention and the layer -------------------------------------------


def test_dense_gat_attention_matches_jax(rng):
    csr, jcsr, n = _csrs(rng)
    h, f = 3, 5
    el, er, fs = _scores(rng, n, h, f, scale=2.0)
    args = (el[..., None], er[..., None], fs.reshape(n, h, f))
    ref = jax.jit(lambda a, b, c: JA.dense_gat_attention(jcsr, a, b, c))(*args)
    out = A.dense_gat_attention(csr, *(_t(a) for a in args))
    np.testing.assert_allclose(out.numpy(), _np(ref), **F32)
    assert not out[n - 3:].any()  # rows without edges: exactly 0


class _JaxGAT(fnn.Module):
    """benchmarking/gat/train.py's model: GATConv(ELU), concatenated heads,
    GATConv, mean over the output heads."""

    graph: object
    hidden: int
    heads: int
    classes: int
    impl: str

    @fnn.compact
    def __call__(self, h):
        h = JaxGATConv(h.shape[-1], self.hidden, num_heads=self.heads, activation=jax.nn.elu,
                       impl=self.impl)(self.graph, h)
        h = h.reshape(h.shape[0], -1)
        return JaxGATConv(h.shape[-1], self.classes, num_heads=1, impl=self.impl)(self.graph, h).mean(axis=1)


class _GAT(torch.nn.Module):
    def __init__(self, graph, fin, hidden, heads, classes, impl):
        super().__init__()
        self.graph = graph
        self.layers = torch.nn.ModuleList([
            GATConv(fin, hidden, heads, activation=torch.nn.functional.elu, impl=impl, device="cpu"),
            GATConv(hidden * heads, classes, 1, impl=impl, device="cpu"),
        ])

    def forward(self, h):
        h = self.layers[0](self.graph, h).reshape(h.shape[0], -1)
        return self.layers[1](self.graph, h).mean(1)


def _graphs(rng, n=150, e=1500):
    src, dst = _edges(rng, n, e)
    edges = np.stack([src, dst], 1)
    return StaticGraph(edges, None, n, device="cpu"), JaxStaticGraph(edges, None, n)


@pytest.mark.parametrize(
    "impl,jimpl,h,f",
    [("dense", "dense", 4, 8), ("sparse", "sparse", 8, 32), ("sparse", "sparse", 3, 100), ("torch", "jnp", 4, 8)],
    ids=["dense", "sparse-flash", "sparse-composed", "torch"],
)
def test_gatconv_routes_match_jax(rng, impl, jimpl, h, f):
    g, jg = _graphs(rng)
    n, fin = 150, 12
    x = rng.standard_normal((n, fin)).astype(np.float32)
    r = rng.standard_normal((n, h, f)).astype(np.float32)
    jconv = JaxGATConv(fin, f, num_heads=h, impl=jimpl)
    params = jax.jit(lambda k: jconv.init(k, jg, jnp.asarray(x)))(jax.random.key(1))
    jout, jgrad = jax.jit(jax.value_and_grad(lambda p: jnp.sum(jconv.apply(p, jg, jnp.asarray(x)) * r)))(params)
    conv = GATConv(fin, f, h, impl=impl, device="cpu")
    conv.load_state_dict(gat_params_from_jax(_numpy_tree(params)))
    out = conv(g, _t(x))
    assert out.shape == (n, h, f)
    (out * _t(r)).sum().backward()
    np.testing.assert_allclose((out * _t(r)).sum().item(), float(jout), rtol=1e-4)
    ref = gat_params_from_jax(_numpy_tree(jgrad))
    for k, p in conv.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **GRAD)


def test_gatconv_init_dropout_and_the_flash_dropout_refusal(rng, monkeypatch):
    conv = GATConv(64, 32, 8, device="cpu", generator=torch.Generator().manual_seed(0))
    w = conv.fc.weight.detach()
    assert w.shape == (256, 64) and conv.fc.bias is None
    assert abs(w.std().item() - np.sqrt(2.0) * np.sqrt(2.0 / (64 + 256))) < 0.01
    assert abs(conv.attn_l.std().item() - np.sqrt(2.0) * np.sqrt(2.0 / (8 + 32))) < 0.05
    g, _ = _graphs(rng)
    x = _t(rng.standard_normal((150, 12)).astype(np.float32))
    drop = GATConv(12, 4, 2, feat_drop=0.3, attn_drop=0.4, impl="dense", device="cpu").train()
    a = drop(g, x, generator=torch.Generator().manual_seed(5))
    b = drop(g, x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, drop.eval()(g, x))
    composed = GATConv(12, 100, 3, attn_drop=0.4, impl="sparse", device="cpu").train()
    assert composed(g, x, generator=torch.Generator().manual_seed(5)).shape == (150, 3, 100)
    # off the reference's flash tilings (2 x 4) attention dropout trains on
    # the edge-domain route, the CPU as the card
    flash = GATConv(12, 4, 2, attn_drop=0.4, impl="sparse", device="cpu").train()
    assert flash(g, x, generator=torch.Generator().manual_seed(5)).shape == (150, 2, 4)
    assert flash.eval()(g, x).shape == (150, 2, 4)
    # at a reference flash tiling (4 x 32) the refusal is gone: route (a),
    # the flash kernels' dropout mode with one seed drawn on the data's
    # device (meta tensors stand in for a card), on the CPU as on the card
    calls = []
    monkeypatch.setattr(A, "flash_gat_attention", lambda csr, el, er, fs, h, slope, sdt, rate, seed: calls.append(
        (h, fs.shape[1] // h, rate, seed.device.type, tuple(seed.shape))) or fs)
    card = GATConv(12, 32, 4, attn_drop=0.4, impl="sparse", device="meta").train()
    assert card(g, torch.empty(150, 12, device="meta")).shape == (150, 4, 32)
    cpu = GATConv(12, 32, 4, attn_drop=0.4, impl="sparse", device="cpu").train()
    assert cpu(g, x, generator=torch.Generator().manual_seed(5)).shape == (150, 4, 32)
    assert calls == [(4, 32, 0.4, "meta", (1,)), (4, 32, 0.4, "cpu", (1,))]


@pytest.mark.parametrize("impl,jimpl", [("sparse", "sparse"), ("dense", "dense")])
def test_two_layer_gat_and_adam_steps_match_optax(rng, impl, jimpl):
    g, jg = _graphs(rng)
    n, fin, hidden, heads, classes = 150, 20, 8, 4, 5
    x = rng.standard_normal((n, fin)).astype(np.float32)
    y = rng.integers(0, classes, n)
    jmodel = _JaxGAT(jg, hidden, heads, classes, jimpl)
    params = jax.jit(jmodel.init)(jax.random.key(42), jnp.asarray(x))
    opt = optax.adam(5e-3)

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    @jax.jit
    def step(p, s):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s)
        return optax.apply_updates(p, updates), s, loss, grads

    model = _GAT(g, fin, hidden, heads, classes, impl)
    model.load_state_dict(gat_params_from_jax(_numpy_tree(params)))
    topt = torch.optim.Adam(model.parameters(), lr=5e-3)
    xt, yt = _t(x), _t(y)
    s = opt.init(params)
    with torch.no_grad():
        np.testing.assert_allclose(model(xt).numpy(), _np(jax.jit(jmodel.apply)(params, jnp.asarray(x))), **MODEL)
    for i in range(5):
        params, s, jloss, jgrads = step(params, s)
        topt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(xt), yt)
        loss.backward()
        if i == 0:
            ref = gat_params_from_jax(_numpy_tree(jgrads))
            for k, p in model.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **GRAD)
        topt.step()
        np.testing.assert_allclose(loss.item(), float(jloss), **MODEL)
    final = gat_params_from_jax(_numpy_tree(params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k, **MODEL)


# -- Pubmed, routing ----------------------------------------------------------


def test_synthetic_pubmed_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    # no download attempt in either package: straight to the synthetic data
    monkeypatch.setattr(JaxDataset, "_offline", True)
    monkeypatch.setattr(STGraphDataset, "_offline", True)
    port, ref = PubmedDataLoader(), JaxPubmed()
    assert port.synthetic and ref.synthetic and port.gdata == ref.gdata
    assert port.gdata["num_nodes"] == 19717 and port.gdata["num_edges"] == 88648
    assert port.get_edges() == ref.get_edges()
    np.testing.assert_array_equal(port.get_all_features(), ref.get_all_features())
    np.testing.assert_array_equal(port.get_all_targets(), ref.get_all_targets())
    assert (tmp_path / ".stgraph" / "dataset_cache_torch" / "Pubmed.json").exists()


def test_aggregate_max_routes_to_k4_for_a_non_cpu_tensor(rng, monkeypatch):
    e = 50_000  # the JAX package's _PALLAS_MIN_EDGES
    csr = build_csr(rng.integers(0, 500, e), rng.integers(0, 500, e), 500, device="cpu")
    calls = []

    def fake_k4(csr_, vals, index=None):
        calls.append((vals.device.type, tuple(vals.shape), index))
        return torch.empty(csr_.num_nodes, vals.shape[1], device=vals.device)

    def torch_max(data, *a, **k):
        calls.append(("torch", tuple(data.shape), None))

    def fake_k5(csr_, vals):
        calls.append(("K5", tuple(vals.shape), None))
        return torch.empty(csr_.num_nodes, vals.shape[1], device=vals.device)

    monkeypatch.setattr(SK, "segment_max_narrow", fake_k4)
    monkeypatch.setattr(SK, "segment_max_wide", fake_k5)
    monkeypatch.setattr(M.seg, "segment_max", torch_max)
    out = M.aggregate(csr, torch.empty(csr.capacity, 8, 1, device="meta"), reduce="max")
    assert out.shape == (500, 8, 1) and calls == [("meta", (csr.capacity, 8), None)]
    # wide values go to K5; CPU tensors and small graphs keep the torch segment ops
    M.aggregate(csr, torch.zeros(csr.capacity, 8), reduce="max")
    assert M.aggregate(csr, torch.empty(csr.capacity, 17, device="meta"), reduce="max").shape == (500, 17)
    small = build_csr(rng.integers(0, 50, 900), rng.integers(0, 50, 900), 50, device="cpu")
    M.aggregate(small, torch.empty(small.capacity, 4, device="meta"), reduce="max")
    assert [c[0] for c in calls] == ["meta", "torch", "K5", "torch"]
    assert calls[2][1] == (csr.capacity, 17)
