"""The temporal-training slice against the JAX package on the same numpy
inputs: the six static-temporal loaders array for array, ``DataTable``'s
printed text, ``drivers.static_temporal_tgcn``'s loop (truncated BPTT with a
short last window, with and without ``--remat``, two Adam epochs),
``bench_tgcn_epoch``'s loss and gradients, and
``drivers.dynamic_temporal_tgcn``'s ``naive``, ``delta`` and ``delta-scan``
epochs with the same negatives in both packages (``pma-scan`` against JAX:
``tests/test_torch_pma.py``), and ``pma-scan``'s hidden states against
``delta-scan``'s.

The JAX side is built from its library under ``jax.jit`` as its scripts
build it (``benchmarking/static-temporal-tgcn/train.py``'s padded, masked
windows scanned in one step; ``benchmarking/dynamic-temporal-tgcn/train.py``'s
stacked snapshots and in-scan deltas), with the negatives passed in where
the script draws them with ``jax.random``.

Tolerances: the loaders are bit for bit (the same numpy calls). The models
run in f32 on the dense adjacency in both packages, summed in another
order: losses to 1e-5 relative, gradients to 1e-4 relative and 1e-5
absolute (as ``tests/test_torch_dynamic.py`` holds TGCN), the parameters
after the Adam steps to 1e-5 absolute (lr 1e-2 times the gradients'
relative error, over at most 8 steps). The three dynamic types agree to
1e-4 (``tests/test_testpack.py``).
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgraph_tpu import StaticGraph as JaxStaticGraph
from stgraph_tpu import dataset as JD
from stgraph_tpu.dataset.base import STGraphDataset as JaxDataset
from stgraph_tpu.graph import DeltaGraph as JaxDeltaGraph
from stgraph_tpu.graph import NaiveGraph as JaxNaiveGraph
from stgraph_tpu.graph.delta_graph import EdgeStore as JaxEdgeStore
from stgraph_tpu.graph.delta_graph import apply_delta as jax_apply_delta
from stgraph_tpu.graph.delta_graph import edge_store_to_csr as jax_edge_store_to_csr
from stgraph_tpu.nn import GCNConv as JaxGCNConv
from stgraph_tpu.nn import TGCN as JaxTGCN
from stgraph_tpu.utils.data_table import DataTable as JaxDataTable
from stgraph_tpu_torch import dataset as D
from stgraph_tpu_torch.convert import gcn_params_from_jax, linear_params_from_jax, tgcn_params_from_jax
from stgraph_tpu_torch.dataset import STGraphDataset
from stgraph_tpu_torch.drivers import dynamic_temporal_tgcn as DT
from stgraph_tpu_torch.drivers import static_temporal_tgcn as ST
from stgraph_tpu_torch.graph import StaticGraph
from stgraph_tpu_torch.nn import GCNConv
from stgraph_tpu_torch.utils import DataTable
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
PARAM = dict(rtol=0, atol=1e-5)
TYPES_AGREE = 1e-4


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    """Both packages' loaders offline, the port's cache in a fresh HOME.
    The JAX loaders keep no cache here: they synthesize their data at every
    call, which costs less than writing it out."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
        mp.setattr(JaxDataset, "_offline", True)
        mp.setattr(JaxDataset, "_save_dataset", lambda self: None)
        mp.setattr(STGraphDataset, "_offline", True)
        yield


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state(params, hparams):
    """The JAX (TGCN, Dense) parameters as the port's two state dicts."""
    return tgcn_params_from_jax(_np(params)), linear_params_from_jax(_np(hparams))


def _assert_grads(model, head, ref_model, ref_head, msg):
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_model[k].numpy(), err_msg=f"{msg} {k}", **GRAD)
    for k, p in head.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_head[k].numpy(), err_msg=f"{msg} head {k}", **GRAD)


# -- the loaders --------------------------------------------------------------

LOADERS = {  # tests/test_datasets.py's arguments
    "hungarycp": ("HungaryCPDataLoader", dict(lags=4)),
    "hungarycp-cutoff": ("HungaryCPDataLoader", dict(lags=4, cutoff_time=100)),
    "wikimath": ("WikiMathDataLoader", dict(lags=8, cutoff_time=50)),
    "pedalme": ("PedalMeDataLoader", dict(lags=4)),
    "windmill-small": ("WindmillOutputDataLoader", dict(size="small", cutoff_time=64)),
    "windmill-medium": ("WindmillOutputDataLoader", dict(size="medium", cutoff_time=64)),
    "windmill-large": ("WindmillOutputDataLoader", dict(size="large", cutoff_time=64)),
    "montevideobus": ("MontevideoBusDataLoader", dict(lags=4, cutoff_time=60)),
    "metrla": ("METRLADataLoader", dict(num_timesteps_in=12, num_timesteps_out=12, cutoff_time=50)),
}


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loader_matches_jax_array_for_array(offline, case):
    """In the module's HOME, whose caches the later tests load: no loader's
    synthetic data here depends on its cutoff (WindmillOutput's holds
    ``max(cutoff, 64)`` timestamps, and every cutoff in this file is at
    most 64)."""
    name, kw = LOADERS[case]
    port, ref = getattr(D, name)(**kw), getattr(JD, name)(**kw)
    assert port.synthetic and ref.synthetic and port.gdata == ref.gdata and port.name == ref.name
    assert port.get_edges() == ref.get_edges()
    np.testing.assert_array_equal(port.get_edge_weights(), ref.get_edge_weights())
    getters = ["get_all_targets"] + (["get_all_features"] if hasattr(ref, "get_all_features") else [])
    for getter in getters:
        a, b = getattr(port, getter)(), getattr(ref, getter)()
        assert type(a) is type(b) and len(a) == len(b)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=getter)
    assert os.path.exists(os.path.join(os.environ["HOME"], ".stgraph", "dataset_cache_torch", f"{port.name}.json"))


def test_loader_reloads_its_synthetic_data_from_the_ports_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(STGraphDataset, "_offline", True)
    first = D.PedalMeDataLoader(lags=4)
    again = D.PedalMeDataLoader(lags=4)
    assert again.synthetic and again.gdata == first.gdata
    np.testing.assert_array_equal(again.get_all_targets(), first.get_all_targets())
    np.testing.assert_array_equal(again.get_edge_weights(), first.get_edge_weights())


def test_windmill_refuses_an_unknown_size():
    with pytest.raises(ValueError):
        D.WindmillOutputDataLoader(size="gigantic")


# -- DataTable ------------------------------------------------------------------


@pytest.mark.parametrize("rich", [True, False])
def test_data_table_prints_the_jax_text(rich, capsys, monkeypatch):
    if not rich:  # the plain-text branch: rich cannot be imported
        monkeypatch.setitem(__import__("sys").modules, "rich.console", None)
    rows = [[0, "0.812345", "1.5000"], [10, "OOM", "OOM"]]
    out = []
    for cls in (DataTable, JaxDataTable):
        table = cls("TGCN windmill_large", ["epoch", "mse", "time (s)"])
        for row in rows:
            table.add_row(row)
        table.display()
        out.append(capsys.readouterr().out)
        with pytest.raises(ValueError):
            table.add_row([1, 2])
    assert out[0] == out[1] and "TGCN windmill_large" in out[0] and "OOM" in out[0]
    assert ("epoch | mse" in out[0]) is not rich


# -- the testpack's METR-LA pack ----------------------------------------------------


def test_metrla_pack_loss_and_gradients_match_jax(offline):
    """``tests/scripts/stgraph_script.py``'s ``_metrla_pack`` computation:
    ``GCNConv(F_in * T_in, 8)`` on METR-LA's first window reshaped to (N, -1)
    (``num_timesteps_in=4, num_timesteps_out=1, cutoff_time=30``), the loss
    ``mean(conv(x)^2)`` and its gradients, from the JAX layer's parameters.
    The JAX side is built here from the library (the pack itself writes a
    log under ``tests/scripts/outputs/``)."""
    kw = dict(num_timesteps_in=4, num_timesteps_out=1, cutoff_time=30)
    ref_loader, loader = JD.METRLADataLoader(**kw), D.METRLADataLoader(**kw)
    n = ref_loader.gdata["num_nodes"]
    jg = JaxStaticGraph(ref_loader.get_edges(), ref_loader.get_edge_weights(), n)
    x = np.asarray(ref_loader.get_all_features())[0].astype(np.float32).reshape(n, -1)
    np.testing.assert_array_equal(np.asarray(loader.get_all_features())[0].reshape(n, -1), x)
    conv = JaxGCNConv(x.shape[-1], 8)
    params = jax.jit(lambda k, x: conv.init(k, jg, x))(jax.random.key(0), jnp.asarray(x))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: (conv.apply(p, jg, jnp.asarray(x)) ** 2).mean()))(params)
    layer = GCNConv(x.shape[-1], 8, device="cpu")
    layer.load_state_dict(gcn_params_from_jax(_np(params)))
    g = StaticGraph(loader.get_edges(), loader.get_edge_weights(), n, device="cpu")
    got = (layer(g, torch.from_numpy(x)) ** 2).mean()
    got.backward()
    np.testing.assert_allclose(got.item(), float(loss), **LOSS)
    ref = gcn_params_from_jax(_np(grads))
    assert x.shape[-1] == int(np.prod(loader.get_all_features().shape[2:])) and set(ref) == {"weight", "bias"}
    for k, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **GRAD)


# -- the static-temporal loop ---------------------------------------------------

STATIC = dict(cutoff=30, lags=4, hidden=8, window=8, epochs=2, lr=1e-2)


def _jax_static_windows(d, lags, hidden, window, steps_per_epoch, epochs, lr):
    """``train.py``'s jitted window step on its padded, masked windows:
    every window's loss and gradients, and the parameters after the last
    Adam step."""
    n = d.gdata["num_nodes"]
    g = JaxStaticGraph(d.get_edges(), d.get_edge_weights(), n)
    ew = jnp.asarray(np.asarray(d.get_edge_weights(), np.float32))
    targets = jnp.asarray(np.stack(d.get_all_targets()), jnp.float32)
    total = targets.shape[0] - lags
    feats = jnp.stack([targets[i:i + lags].T for i in range(total)])
    ys = targets[lags:]
    model, head = JaxTGCN(lags, hidden), fnn.Dense(1)
    params = jax.jit(lambda k, x: model.init(k, g, x, edge_weight=ew))(jax.random.key(0), feats[0])
    hparams = head.init(jax.random.key(1), jnp.zeros((n, hidden)))
    opt = optax.adam(lr)
    n_windows = -(-total // window)
    assert n_windows == steps_per_epoch
    pad = n_windows * window - total
    feats_w = jnp.pad(feats, ((0, pad), (0, 0), (0, 0))).reshape(n_windows, window, n, lags)
    ys_w = jnp.pad(ys, ((0, pad), (0, 0))).reshape(n_windows, window, n)
    mask_w = jnp.asarray(np.pad(np.ones(total, np.float32), (0, pad)).reshape(n_windows, window))

    @jax.jit  # train.py's window_step, which also returns the gradients
    def window_step(ps, state, hidden_state, xw, yw, mw):
        def loss_fn(ps):
            p, hp = ps

            def body(h, xym):
                x_t, y_t, m_t = xym
                h = model.apply(p, g, x_t, edge_weight=ew, hidden=h)
                y_hat = head.apply(hp, h)[:, 0]
                return h, m_t * jnp.mean((y_hat - y_t) ** 2)

            h_out, losses = jax.lax.scan(body, hidden_state, (xw, yw, mw))
            return losses.sum() / jnp.maximum(mw.sum(), 1.0), h_out

        (loss, h_out), grads = jax.value_and_grad(loss_fn, has_aux=True)(ps)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(ps, updates), state, jax.lax.stop_gradient(h_out), loss, grads

    ps = (params, hparams)
    init = _state(*ps)
    state = opt.init(ps)
    records = []
    for _ in range(epochs):
        h = jnp.zeros((n, hidden))
        for wi in range(n_windows):
            ps, state, h, loss, grads = window_step(ps, state, h, feats_w[wi], ys_w[wi], mask_w[wi])
            records.append((float(loss), _state(*grads)))
    return init, records, _state(*ps)


@pytest.fixture(scope="module")
def static_reference(offline):
    c = STATIC
    d = JD.WikiMathDataLoader(lags=c["lags"], cutoff_time=c["cutoff"])
    windows = -(-(c["cutoff"] - c["lags"]) // c["window"])
    return _jax_static_windows(d, c["lags"], c["hidden"], c["window"], windows, c["epochs"], c["lr"])


@pytest.mark.parametrize("remat", [False, True])
def test_static_temporal_loop_matches_jax(static_reference, remat):
    """Two Adam epochs on WikiMath at 26 timesteps in windows of 8 (the last
    one 2 long): each window's loss and gradients, and the parameters after
    the eight steps. ``--remat`` recomputes the same arithmetic, so one JAX
    run (without ``jax.checkpoint``) is the reference of both."""
    c = STATIC
    init, records, final = static_reference
    d = D.WikiMathDataLoader(lags=c["lags"], cutoff_time=c["cutoff"])
    tr = ST.StaticTemporalTrainer(d, c["lags"], c["hidden"], c["window"], c["lr"], remat=remat, device="cpu")
    assert (tr.total, tr.num_windows, len(tr.window_range(tr.num_windows - 1))) == (26, 4, 2)
    tr.model.load_state_dict(init[0])
    tr.head.load_state_dict(init[1])
    it = iter(records)
    for epoch in range(c["epochs"]):
        h = tr.zero_hidden()
        for wi in range(tr.num_windows):
            loss, h = tr.window_backward(h, wi)
            ref_loss, (ref_model, ref_head) = next(it)
            np.testing.assert_allclose(loss.item(), ref_loss, err_msg=f"epoch {epoch} window {wi}", **LOSS)
            _assert_grads(tr.model, tr.head, ref_model, ref_head, f"epoch {epoch} window {wi}")
            tr.opt.step()
    for mod, ref in zip((tr.model, tr.head), final):
        for k, v in mod.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **PARAM)


def test_static_temporal_run_prints_its_epochs_and_rows(offline, tmp_path, capsys):
    csv_path = tmp_path / "out" / "static.csv"
    r = ST.main(["--dataset", "hungarycp", "--num_epochs", "4", "--num_hidden", "8", "--feat_size", "4",
                 "--cutoff_time", "30", "--backprop_every", "10", "--cpu", "--results_csv", str(csv_path)])
    out = capsys.readouterr().out
    assert not r["oom"] and len(r["mse"]) == 4 and r["windows"] == 3 and np.isfinite(r["mse"]).all()
    assert f"^^^0^^^{r['avg_epoch_s']:.6f}" in out and r["avg_epoch_s"] == r["epoch_s"][3]
    rows = csv_path.read_text().splitlines()
    assert rows[0] == "dataset,feat_size,backprop_every,epoch_time_s,mse" and rows[1].startswith("hungarycp,4,10,")


# -- bench_tgcn_epoch -----------------------------------------------------------


def test_bench_tgcn_epoch_loss_and_gradients_match_jax(offline):
    """``bench.py``'s epoch at cutoff 20 (12 timesteps): the MSE averaged
    over every timestep and its gradients, no optimiser step."""
    cutoff = 20
    wind = JD.WindmillOutputDataLoader(size="small", lags=8, cutoff_time=cutoff)
    n = wind.gdata["num_nodes"]
    g = JaxStaticGraph(wind.get_edges(), wind.get_edge_weights(), n)
    targets = np.stack(wind.get_all_targets()).astype(np.float32)
    t_steps = targets.shape[0] - 8
    feats = jnp.asarray(np.stack([targets[i:i + 8].T for i in range(t_steps)]))
    ys = jnp.asarray(targets[8:])
    ew = jnp.asarray(wind.get_edge_weights(), jnp.float32)
    model, head = JaxTGCN(8, 16), fnn.Dense(1)
    params = jax.jit(lambda k, x: model.init(k, g, x, edge_weight=ew))(jax.random.key(0), feats[0])
    hp = jax.jit(head.init)(jax.random.key(1), jnp.zeros((n, 16)))

    @jax.jit
    def epoch(params, hp):
        def loss_fn(params, hp):
            def body(hidden, xy):
                hidden = model.apply(params, g, xy[0], edge_weight=ew, hidden=hidden)
                return hidden, jnp.mean((head.apply(hp, hidden)[:, 0] - xy[1]) ** 2)

            return jax.lax.scan(body, jnp.zeros((n, 16)), (feats, ys))[1].mean()

        return jax.value_and_grad(loss_fn, argnums=(0, 1))(params, hp)

    loss, grads = epoch(params, hp)
    tr = ST.tgcn_epoch_trainer(cutoff, device="cpu")
    assert (tr.total, tr.num_windows, tr.hidden, tr.lags) == (t_steps, 1, 16, 8)
    init = _state(params, hp)
    tr.model.load_state_dict(init[0])
    tr.head.load_state_dict(init[1])
    r = ST.bench_tgcn_epoch(iters=1, warmup=0, trainer=tr)
    assert r["timesteps"] == t_steps and r["tgcn_epoch_s"] > 0
    np.testing.assert_allclose(r["loss"], float(loss), **LOSS)
    _assert_grads(tr.model, tr.head, *_state(*grads), "bench_tgcn_epoch")


# -- the dynamic-temporal types -------------------------------------------------

DYN = dict(cutoff=12, lags=4, hidden=8, epochs=2, lr=1e-2)


def _jax_link_loss(h, cols, rows, mask, neg_s, neg_d):
    """``train.py``'s ``step_loss`` tail with the negatives given."""
    n = h.shape[0]

    def decode(s, d):
        return jnp.sum(h[s] * h[d], axis=-1)

    pos = decode(jnp.minimum(cols, n - 1), jnp.minimum(rows, n - 1))
    neg = decode(neg_s, neg_d)
    loss = (optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos))
            + optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)))
    return jnp.sum(jnp.where(mask, loss, 0.0)) / jnp.maximum(mask.sum(), 1)


def _jax_dynamic_reference(d, negs, lags, hidden, epochs, lr):
    """``train.py``'s epoch step for ``naive`` and ``delta`` (stacked snapshot
    CSRs: one jitted step takes either) and ``delta-scan`` (apply_delta and
    edge_store_to_csr inside the scan), the negatives given: the initial
    parameters, and each type's epochs' losses and gradients."""
    edge_lists, weight_lists = d.get_edges(), d.get_edge_weights()
    graphs = {"naive": JaxNaiveGraph(edge_lists, weight_lists), "delta": JaxDeltaGraph(edge_lists, weight_lists)}
    n = graphs["naive"].get_num_nodes()
    feats = jnp.asarray(np.stack(d.get_all_features()), jnp.float32)
    t_total = feats.shape[0]
    model, opt = JaxTGCN(lags, hidden), optax.adam(lr)
    params = jax.jit(lambda k, x: model.init(k, graphs["naive"].get_graph(lags), x))(jax.random.key(0), feats[0])

    def csr_loss(p, neg, stacked, weights):
        def body(h, xs):
            csr, x_t, w_t, (ns, nd) = xs
            h = model.apply(p, csr, x_t, edge_weight=w_t, hidden=h)
            return h, _jax_link_loss(h, csr.cols, csr.rows, csr.edge_mask, ns, nd)

        return jax.lax.scan(body, jnp.zeros((n, hidden)), (stacked, feats, weights, neg))[1].mean()

    def scan_loss(p, neg, sa, sd, sw, s0):
        def body(carry, xs):
            h, rows, cols, ws, ne = carry
            add, dele, add_w, x_t, (ns, nd) = xs
            store = jax_apply_delta(JaxEdgeStore(rows, cols, ne, n, ws), add[:, 1], add[:, 0], dele[:, 1],
                                    dele[:, 0], add_weights=add_w)
            csr = jax_edge_store_to_csr(store)
            h = model.apply(p, csr, x_t, edge_weight=store.weights.reshape(-1, 1), hidden=h)
            loss = _jax_link_loss(h, csr.cols, csr.rows, csr.edge_mask, ns, nd)
            return (h, store.rows, store.cols, store.weights, store.num_edges), loss

        return jax.lax.scan(body, (jnp.zeros((n, hidden)),) + s0, (sa, sd, sw, feats, neg))[1].mean()

    def step(loss_fn):
        @jax.jit
        def epoch_step(p, state, neg, *graph):
            loss, grads = jax.value_and_grad(loss_fn)(p, neg, *graph)
            updates, state = opt.update(grads, state)
            return optax.apply_updates(p, updates), state, loss, grads

        return epoch_step

    csr_step, scan_step = step(csr_loss), step(scan_loss)
    inputs = {kind: (csr_step, (jax.tree_util.tree_map(lambda x: x[lags:lags + t_total], g.stacked()),
                                g.stacked_weights()[lags:lags + t_total]))
              for kind, g in graphs.items()}
    g = graphs["delta"]
    s0 = g.snapshot_store(lags - 1)
    inputs["delta-scan"] = (scan_step, tuple(x[lags:lags + t_total] for x in g.staged_deltas())
                            + (g.staged_add_weights()[lags:lags + t_total],
                               tuple(jnp.asarray(x) for x in (s0.rows, s0.cols, s0.weights, s0.num_edges))))
    out = {}
    for kind, (epoch_step, graph) in inputs.items():
        p, state, out[kind] = params, opt.init(params), []
        for e in range(epochs):
            p, state, loss, grads = epoch_step(p, state, tuple(jnp.asarray(x) for x in negs[e]), *graph)
            out[kind].append((float(loss), tgcn_params_from_jax(_np(grads))))
    return tgcn_params_from_jax(_np(params)), out


@pytest.fixture(scope="module")
def dynamic_data(offline):
    c = DYN
    d = JD.EnglandCovidDataLoader(lags=c["lags"], cutoff_time=c["cutoff"])
    graph = JaxNaiveGraph(d.get_edges())
    n, cap, steps = graph.get_num_nodes(), graph._capacity, len(d.get_all_features())
    rng = np.random.default_rng(0)
    negs = [tuple(rng.integers(0, n, (steps, cap)).astype(np.int32) for _ in range(2)) for _ in range(c["epochs"])]
    return d, negs, cap


@pytest.fixture(scope="module")
def dynamic_reference(dynamic_data):
    c, (d, negs, _) = DYN, dynamic_data
    return _jax_dynamic_reference(d, negs, c["lags"], c["hidden"], c["epochs"], c["lr"])


@pytest.mark.parametrize("kind", ["naive", "delta", "delta-scan"])
def test_dynamic_temporal_epochs_match_jax(dynamic_data, dynamic_reference, kind):
    """Two Adam epochs on England-COVID (8 timesteps from snapshot 4), the
    same negatives fed to both packages: each epoch's loss and parameter
    gradients; and the three types' loss trajectories agree."""
    c, (_, negs, cap) = DYN, dynamic_data
    d = D.EnglandCovidDataLoader(lags=c["lags"], cutoff_time=c["cutoff"])
    init, ref = dynamic_reference[0], dynamic_reference[1][kind]
    epoch = [0]

    def negatives(t, slots):
        assert slots == cap
        return tuple(torch.from_numpy(x[t]) for x in negs[epoch[0]])

    tr = DT.DynamicTemporalTrainer(d.get_edges(), d.get_edge_weights(), d.get_all_features(), kind, c["lags"],
                                   c["hidden"], c["lr"], device="cpu", negatives=negatives)
    assert tr.steps == c["cutoff"] - c["lags"]
    tr.model.load_state_dict(init)
    for e, (ref_loss, ref_grads) in enumerate(ref):
        epoch[0] = e
        tr.opt.zero_grad(set_to_none=True)
        loss = tr.epoch_loss()
        loss.backward()
        np.testing.assert_allclose(loss.item(), ref_loss, err_msg=f"{kind} epoch {e}", **LOSS)
        for k, p in tr.model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), ref_grads[k].numpy(), err_msg=f"{kind} epoch {e} {k}", **GRAD)
        tr.opt.step()
    losses = {k: [r[0] for r in v] for k, v in dynamic_reference[1].items()}
    np.testing.assert_allclose(losses[kind], losses["naive"], rtol=0, atol=TYPES_AGREE)


def test_dynamic_types_agree_and_pma_scan_follows_delta_scan(dynamic_data, capsys):
    """The trainers' own negatives (their generators, the same seed): ``naive``,
    ``delta`` and ``delta-scan`` give one loss trajectory; the script's run
    prints its table, build time and average. ``pma-scan`` (its losses draw
    one negative a slot of another layout, so they are not comparable) gives
    ``delta-scan``'s hidden state at every timestep of an epoch from the same
    parameters, and the script runs it."""
    c = DYN
    d = D.EnglandCovidDataLoader(lags=c["lags"], cutoff_time=c["cutoff"])
    losses, hiddens = {}, {}
    for kind in ("naive", "delta", "delta-scan", "pma-scan"):
        tr = DT.DynamicTemporalTrainer(d.get_edges(), d.get_edge_weights(), d.get_all_features(), kind, c["lags"],
                                       c["hidden"], c["lr"], device="cpu")
        hiddens[kind] = []
        with torch.no_grad():
            tr.epoch_loss(hiddens[kind])
        losses[kind] = [tr.epoch().item() for _ in range(c["epochs"])]
    for kind in ("delta", "delta-scan"):
        np.testing.assert_allclose(losses[kind], losses["naive"], rtol=0, atol=TYPES_AGREE)
    assert len(hiddens["pma-scan"]) == len(hiddens["delta-scan"]) == c["cutoff"] - c["lags"]
    for t, (a, b) in enumerate(zip(hiddens["pma-scan"], hiddens["delta-scan"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5, err_msg=f"timestep {t}")
    assert np.all(np.isfinite(losses["pma-scan"]))
    r = DT.main(["--type", "delta-scan", "--num_epochs", "2", "--feat_size", "4", "--num_hidden", "8", "--cpu"])
    out = capsys.readouterr().out
    assert "graph build time:" in out and f"^^^0^^^{r['avg_epoch_s']:.6f}" in out and r["timesteps"] == 57
    r = DT.main(["--type", "pma-scan", "--num_epochs", "2", "--feat_size", "4", "--num_hidden", "8", "--cpu"])
    out = capsys.readouterr().out
    assert "pma-scan" in out and f"^^^0^^^{r['avg_epoch_s']:.6f}" in out and r["timesteps"] == 57
    assert np.all(np.isfinite(r["loss"]))
