"""The training slice against the JAX package on the same numpy inputs: K2's
plain version, the SpMM backward (K1 on the transpose CSR, K2) through the
port's ``autograd.Function``, AdamW steps of a GCN, TGCN, the synthetic
Cora, checkpoints and ``Predictor.from_checkpoint``.

Tolerances: the port rounds where the JAX kernels round (a bf16 stream
rounds features, weights and products to bf16 and sums in f32), so only
the order of f32 sums differs: 1e-5 relative plus 1e-5 absolute for
values of order one to ten. Adam divides each gradient by its running
scale, so a summation-order difference of 1e-7 in a small gradient moves
a parameter by up to lr * 1e-7 / |g|; five steps at lr = 1e-2 stay below
1e-5 for the gradients these graphs give.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgraph_tpu.dataset.base import STGraphDataset as JaxDataset
from stgraph_tpu.dataset.cora_dataloader import CoraDataLoader as JaxCora
from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.graph.static_graph import StaticGraph as JaxStaticGraph
from stgraph_tpu.nn.gcn_conv import GCNConv as JaxGCNConv
from stgraph_tpu.nn.tgcn import TGCN as JaxTGCN
from stgraph_tpu.ops import segment_pallas as NSP
from stgraph_tpu.ops import spmm_pallas
from stgraph_tpu.utils.train_utils import accuracy as jax_accuracy
from stgraph_tpu_torch.convert import gcn_params_from_jax, tgcn_params_from_jax
from stgraph_tpu_torch.dataset import CoraDataLoader, STGraphDataset
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import TGCN, GCNConv
from stgraph_tpu_torch.ops import spmm_cuda
from stgraph_tpu_torch.ops.spmm_kernels import (
    spmm_rowmask,
    spmm_rowmask_bwd,
    spmm_rowmask_bwd_plain,
)
from stgraph_tpu_torch.serve import Predictor
from stgraph_tpu_torch.utils import Checkpointer, EarlyStopping, accuracy

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


# K2's plain version against the Pallas kernel in interpret mode, on the
# single-head shapes of tests/test_message.py; one heavy row and empty rows.
@pytest.mark.parametrize("f,stream", [(128, None), (128, "bf16"), (47, "bf16")])
def test_k2_plain_matches_pallas_interpret(rng, f, stream):
    n, e = 300, 4000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[src > n - 20] = 5  # the transpose's rows are sources
    csr_t = build_csr(src, dst, n, device="cpu").transpose()
    jcsr_t = jax_build_csr(src, dst, n).transpose()
    cap = csr_t.capacity
    w_t = rng.standard_normal(cap).astype(np.float32)
    g = rng.standard_normal((n, f)).astype(np.float32)
    fs = rng.standard_normal((n, f)).astype(np.float32)
    sd = torch.bfloat16 if stream else None
    dh, dw = spmm_rowmask_bwd(csr_t, torch.from_numpy(w_t), torch.from_numpy(g),
                              torch.from_numpy(fs), stream_dtype=sd)
    ref_dh, ref_dw = NSP.spmm_rowmask_bwd(
        jcsr_t, jnp.asarray(w_t[:, None]), jnp.asarray(g), jnp.asarray(fs),
        interpret=True, stream_dtype=jnp.bfloat16 if stream else None,
    )
    assert dh.dtype == dw.dtype == torch.float32 and dw.shape == (cap,)
    np.testing.assert_allclose(dh.numpy(), _np(ref_dh), **TOL)
    e_real = csr_t.num_edges
    np.testing.assert_allclose(dw.numpy()[:e_real], _np(ref_dw)[:e_real, 0], **TOL)
    np.testing.assert_array_equal(dw.numpy()[e_real:], 0.0)
    np.testing.assert_array_equal(dh.numpy()[n - 19:], 0.0)


def test_k2_plain_edge_blocks_give_the_same_result(rng):
    n, e = 90, 700
    csr_t = build_csr(rng.integers(0, n, e), rng.integers(0, n, e), n, device="cpu").transpose()
    w = torch.from_numpy(rng.random(csr_t.capacity).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((n, 9)).astype(np.float32))
    fs = torch.from_numpy(rng.standard_normal((n, 9)).astype(np.float32))
    whole = spmm_rowmask_bwd_plain(csr_t, w, g, fs, torch.bfloat16)
    blocked = spmm_rowmask_bwd_plain(csr_t, w, g, fs, torch.bfloat16, edge_block=37)
    assert all(torch.equal(a, b) for a, b in zip(whole, blocked))


@pytest.fixture
def forced_bf16_stream(monkeypatch):
    """Every graph streams bf16, in both packages (the rule is a module
    constant in each)."""
    monkeypatch.setattr(spmm_pallas, "_BF16_STREAM_MIN_EDGES", 0)
    monkeypatch.setattr(spmm_cuda, "_BF16_STREAM_MIN_EDGES", 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_spmm_grads_match_jax_custom_vjp(rng, request, weighted, stream):
    if stream == "bf16":
        request.getfixturevalue("forced_bf16_stream")
    n, e, f = 200, 3000, 64  # tests/test_message.py's weighted-grad shapes
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 4, e)
    dst[:1200] = 9  # a heavy row: split work items on the card
    csr = build_csr(src, dst, n, device="cpu")
    jcsr = jax_build_csr(src, dst, n)
    h = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.standard_normal(csr.capacity).astype(np.float32)
    gref = rng.standard_normal((n, f)).astype(np.float32)

    def loss_jax(a, b):
        out = spmm_pallas.spmm(jcsr, a, b if weighted else None, interpret=True)
        return jnp.sum(out * gref)

    jh, jw = jax.grad(loss_jax, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_() if weighted else None
    (spmm_cuda.spmm(csr, ht, wt) * torch.from_numpy(gref)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), _np(jh), **TOL)
    if weighted:
        np.testing.assert_allclose(wt.grad.numpy(), _np(jw), **TOL)


def test_backward_runs_k1_on_the_transpose_and_k2_through_the_function(rng, monkeypatch):
    """The CPU gradient comes from the port's backward, not from autograd of
    the plain forward: K1 on the transpose without weights, K2 with them."""
    calls = []
    monkeypatch.setattr(spmm_cuda, "spmm_rowmask",
                        lambda csr, w, x, **k: calls.append(("k1", csr, w is None)) or spmm_rowmask(csr, w, x, **k))
    monkeypatch.setattr(spmm_cuda, "spmm_rowmask_bwd",
                        lambda csr_t, *a, **k: calls.append(("k2", csr_t, False)) or spmm_rowmask_bwd(csr_t, *a, **k))
    csr = build_csr(rng.integers(0, 30, 200), rng.integers(0, 30, 200), 30, device="cpu")
    h = torch.from_numpy(rng.standard_normal((30, 5)).astype(np.float32)).requires_grad_()
    spmm_cuda.spmm(csr, h).sum().backward()
    assert calls == [("k1", csr, True), ("k1", csr.transpose(), True)]
    calls.clear()
    w = torch.ones(csr.capacity)
    spmm_cuda.spmm(csr, h, w).sum().backward()
    assert [c[0] for c in calls] == ["k1", "k2"] and calls[1][1] is csr.transpose()


def test_edge_perms_match_the_jax_construction(rng):
    n, e = 50, 300
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    csr = build_csr(src, dst, n, capacity=320, device="cpu")
    jcsr = jax_build_csr(src, dst, n, capacity=320)
    perm_t, perm_f, emask = csr.edge_perms()
    w = jnp.asarray(np.arange(320, dtype=np.float32))
    # spmm_pallas routes weights into transpose order through the shared eids
    ref_t = spmm_pallas._to_blocked_w_mh(jcsr.transpose(), jcsr, w[:, None])[:, 0]
    np.testing.assert_array_equal(perm_t.numpy()[:e], _np(ref_t)[:e])
    np.testing.assert_array_equal(perm_t.numpy()[perm_f.numpy()][:e], np.arange(e))
    np.testing.assert_array_equal(emask.numpy(), (_np(jcsr.rows) < n).astype(np.float32))


def test_gcnconv_edge_weight_grad_matches_jax_after_serving(rng):
    """A user's edge weight that needs a gradient gets K2's ``dw`` through
    the CSR permutation; a forward under ``inference_mode`` first (as a
    ``Predictor`` runs) leaves nothing behind that breaks training."""
    n, e, fin, fout = 70, 500, 9, 6
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, fin)).astype(np.float32)
    ew = rng.random(e).astype(np.float32)
    r = rng.standard_normal((n, fout)).astype(np.float32)
    jg = JaxStaticGraph(edges, None, n)
    jconv = JaxGCNConv(fin, fout, impl="jnp")
    params = jax.jit(lambda k: jconv.init(k, jg, jnp.asarray(x)))(jax.random.key(4))
    jgp, jgw = jax.jit(jax.grad(lambda p, w: jnp.sum(jconv.apply(p, jg, jnp.asarray(x), w) * r),
                                argnums=(0, 1)))(params, jnp.asarray(ew))
    conv = GCNConv(fin, fout, impl="kernel", device="cpu")
    conv.load_state_dict(gcn_params_from_jax(_numpy_tree(params)))
    g = StaticGraph(edges, None, n, device="cpu")
    with torch.inference_mode():
        conv(g, torch.from_numpy(x), torch.from_numpy(ew))
    w = torch.from_numpy(ew).requires_grad_()
    (conv(g, torch.from_numpy(x), w) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(w.grad.numpy(), _np(jgw), **TOL)
    ref = gcn_params_from_jax(_numpy_tree(jgp))
    np.testing.assert_allclose(conv.weight.grad.numpy(), ref["weight"].numpy(), **TOL)


class _JaxGCN(fnn.Module):
    graph: object
    dims: tuple

    @fnn.compact
    def __call__(self, h):
        for i, (a, b) in enumerate(zip(self.dims[:-1], self.dims[1:])):
            last = i == len(self.dims) - 2
            h = JaxGCNConv(a, b, activation=None if last else jax.nn.relu, impl="jnp")(self.graph, h)
        return h


class _GCN(torch.nn.Module):
    def __init__(self, graph, dims, impl):
        super().__init__()
        self.graph = graph
        self.layers = torch.nn.ModuleList(
            GCNConv(a, b, activation=None if i == len(dims) - 2 else torch.relu, impl=impl, device="cpu")
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
        )

    def forward(self, h):
        for layer in self.layers:
            h = layer(self.graph, h)
        return h


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_gcn_adamw_steps_match_optax(rng, impl):
    n, e, dims = 150, 900, (12, 16, 5)
    edges = np.stack([rng.integers(0, n - 5, e), rng.integers(0, n - 5, e)], 1)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], n)
    jmodel = _JaxGCN(JaxStaticGraph(edges, None, n), dims)
    params = jax.jit(jmodel.init)(jax.random.key(2), jnp.asarray(x))
    opt = optax.adamw(1e-2, weight_decay=5e-4)

    @jax.jit
    def step(p, s):
        def loss_fn(p):
            logits = jmodel.apply(p, jnp.asarray(x))
            return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss

    model = _GCN(StaticGraph(edges, None, n, device="cpu"), dims, impl)
    model.load_state_dict(gcn_params_from_jax(_numpy_tree(params)))
    topt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=5e-4)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    s = opt.init(params)
    for _ in range(5):
        params, s, jloss = step(params, s)
        topt.zero_grad()
        loss = torch.nn.functional.cross_entropy(model(xt), yt)
        loss.backward()
        topt.step()
        np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    final = gcn_params_from_jax(_numpy_tree(params))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), final[k].numpy(), err_msg=k, **TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_tgcn_matches_jax(rng, weighted):
    n, e, cin, cout = 60, 400, 6, 8
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    ew = rng.random(e).astype(np.float32) if weighted else None
    xs = [rng.standard_normal((n, cin)).astype(np.float32) for _ in range(2)]
    target = rng.standard_normal((n, cout)).astype(np.float32)
    jg = JaxStaticGraph(edges, None, n)
    jlayer = JaxTGCN(cin, cout, impl="jnp")
    params = jax.jit(lambda k: jlayer.init(k, jg, jnp.asarray(xs[0])))(jax.random.key(3))

    def jloss(p, xs):  # two timesteps, the hidden state threaded through
        h = None
        for x in xs:
            h = jlayer.apply(p, jg, x, None if ew is None else jnp.asarray(ew), h)
        return jnp.sum((h - target) ** 2), h

    (jl, jh), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, [jnp.asarray(x) for x in xs]
    )

    layer = TGCN(cin, cout, impl="kernel", device="cpu")
    layer.load_state_dict(tgcn_params_from_jax(_numpy_tree(params)))
    g = StaticGraph(edges, None, n, device="cpu")
    xt = [torch.from_numpy(x).requires_grad_() for x in xs]
    h = None
    for x in xt:
        h = layer(g, x, None if ew is None else torch.from_numpy(ew), h)
    loss = ((h - torch.from_numpy(target)) ** 2).sum()
    loss.backward()
    np.testing.assert_allclose(h.detach().numpy(), _np(jh), **TOL)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    ref = tgcn_params_from_jax(_numpy_tree(jgp))
    for k, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **TOL)
    for x, jx in zip(xt, jgx):
        np.testing.assert_allclose(x.grad.numpy(), _np(jx), **TOL)


def test_tgcn_init_is_lecun_normal_dense_and_xavier_gcn():
    layer = TGCN(64, 256, device="cpu", generator=torch.Generator().manual_seed(0))
    w = layer.linear_z.weight.detach()
    std = 1.0 / np.sqrt(512) / 0.87962566103423978
    assert w.shape == (256, 512) and w.abs().max() <= 2 * std
    assert abs(w.std().item() - 1.0 / np.sqrt(512)) < 0.02 / np.sqrt(512)
    assert not layer.linear_r.bias.any() and not layer.conv_h.bias.any()
    with pytest.raises(ValueError):
        tgcn_params_from_jax({"params": {"conv_z": {}}})


def test_synthetic_cora_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    # no download attempt in either package: straight to the synthetic data
    monkeypatch.setattr(JaxDataset, "_offline", True)
    monkeypatch.setattr(STGraphDataset, "_offline", True)
    port, ref = CoraDataLoader(), JaxCora()
    assert port.synthetic and ref.synthetic and port.gdata == ref.gdata
    assert port.get_edges() == ref.get_edges()
    np.testing.assert_array_equal(port.get_all_features(), ref.get_all_features())
    np.testing.assert_array_equal(port.get_all_targets(), ref.get_all_targets())
    assert (tmp_path / ".stgraph" / "dataset_cache_torch" / "Cora.json").exists()
    again = CoraDataLoader(cache_dir=str(tmp_path / ".stgraph" / "dataset_cache_torch"))
    assert again.synthetic and again.get_edges() == port.get_edges()


def test_checkpointer_round_trip_and_keep_last_k(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "run"), keep=2)
    assert ckpt.restore() is None and ckpt.latest_step() is None
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    for step in (1, 5, 9):
        ckpt.save(step, {"model": model.state_dict(), "optimizer": opt.state_dict(), "step": step})
    assert ckpt.all_steps() == [5, 9] and ckpt.latest_step() == 9
    like = {"model": model.state_dict(), "optimizer": opt.state_dict(), "step": 0}
    state = ckpt.restore(like=like)
    assert state["step"] == 9
    assert all(torch.equal(state["model"][k], v) for k, v in model.state_dict().items())
    fresh = torch.optim.AdamW(torch.nn.Linear(3, 2).parameters(), lr=1e-2)
    fresh.load_state_dict(ckpt.restore(step=5)["optimizer"])
    assert torch.equal(fresh.state_dict()["state"][0]["exp_avg"], opt.state_dict()["state"][0]["exp_avg"])
    with pytest.raises(ValueError):
        ckpt.restore(like={"model": {}, "optimizer": {}, "step": 0})


def test_predictor_from_checkpoint_matches_a_direct_forward(rng, tmp_path):
    n, e = 80, 500
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    model = _GCN(StaticGraph(edges, None, n, device="cpu"), (10, 8, 3), "kernel")
    x = torch.from_numpy(rng.standard_normal((n, 10)).astype(np.float32))
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(str(tmp_path), model, dict(model.state_dict()), (x,), device="cpu")
    Checkpointer(str(tmp_path)).save(3, dict(model.state_dict()))
    predictor = Predictor.from_checkpoint(str(tmp_path), model, dict(model.state_dict()), (x,), device="cpu")
    assert torch.equal(predictor(x), model(x).detach())


def test_early_stopping_and_accuracy_match_jax(rng):
    logits = rng.standard_normal((50, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 50)
    assert accuracy(torch.from_numpy(logits), torch.from_numpy(labels)) == pytest.approx(
        jax_accuracy(jnp.asarray(logits), jnp.asarray(labels))
    )
    stop = EarlyStopping(patience=2)
    model = torch.nn.Linear(2, 2)
    assert not stop.step(0.5, model)
    best = model.weight.detach().clone()
    with torch.no_grad():
        model.weight.add_(1.0)
    assert not stop.step(0.4, model) and stop.step(0.5, dict(model.state_dict()))
    assert stop.best_score == 0.5 and torch.equal(stop.best_params["weight"], best)
