"""EvolveGCN-O and -H against the JAX package on the same numpy inputs: the
layers (one step, two chained steps, the gradients of a two-step loss with
respect to every parameter) on the port's dense route and on its kernel
route (K1 and K2's plain versions on the CPU), on a graph without and one
with padding slots (``tests/test_evolvegcn.py``'s sizes: N = 40, E = 160,
F = 8, 16 outputs); JAX's own shape, evolution and gradient-flow checks;
the H variant's top rows (ties to the lower index, as ``lax.top_k``) and
its refusal of a graph with fewer nodes than outputs; and
``drivers.evolvegcn``'s two Adam epochs of both variants on WikiMath (12
timesteps, hidden 8) against the same epochs built from
``benchmarking/evolvegcn/train.py``'s recipe.

The JAX side runs under ``jax.jit`` (its eager path breaks on padded graphs)
from the parameters that ``convert.evolvegcn_params_from_jax`` carries over.

Tolerances (``tests/test_torch_temporal.py``'s): both packages run f32,
summed in other orders. Outputs, evolved weights and losses to 1e-5
relative (outputs and weights also 1e-6 absolute, for entries near 0),
gradients to 1e-4 relative and 1e-5 absolute, the parameters after two Adam
steps to 1e-5 absolute.
"""

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
from stgraph_tpu.nn import EvolveGCNH as JaxEvolveGCNH
from stgraph_tpu.nn import EvolveGCNO as JaxEvolveGCNO
from stgraph_tpu_torch.convert import evolvegcn_params_from_jax, linear_params_from_jax
from stgraph_tpu_torch.dataset import STGraphDataset
from stgraph_tpu_torch.drivers import evolvegcn as EV
from stgraph_tpu_torch.graph import StaticGraph
from stgraph_tpu_torch.nn import EvolveGCNH, EvolveGCNO
from stgraph_tpu_torch.nn.evolvegcn import _top_rows
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

VALUE = dict(rtol=1e-5, atol=1e-6)
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
PARAM = dict(rtol=0, atol=1e-5)
N, E, F, OUT = 40, 160, 8, 16
VARIANTS = {"o": (JaxEvolveGCNO, EvolveGCNO), "h": (JaxEvolveGCNH, EvolveGCNH)}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _graphs(edges, pad_multiple):
    return (JaxStaticGraph(edges, None, N, pad_multiple=pad_multiple),
            StaticGraph(edges, None, N, pad_multiple=pad_multiple, device="cpu"))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    edges = [(int(s), int(d)) for s, d in zip(rng.integers(0, N, E), rng.integers(0, N, E))]
    x = rng.standard_normal((N, F)).astype(np.float32)
    return edges, x


def _pair(variant, jg, x, impl):
    """A JAX layer with its parameters, and the port's layer loaded from them."""
    jcls, cls = VARIANTS[variant]
    jlayer = jcls(F, OUT)
    params = jax.jit(lambda k, x: jlayer.init(k, jg, x))(jax.random.key(0), jnp.asarray(x))
    layer = cls(F, OUT, impl=impl, device="cpu")
    layer.load_state_dict(evolvegcn_params_from_jax(_np(params)))
    return jlayer, params, layer


def _jax_two_steps(jlayer, params, jg, x):
    """(out1, w1, out2, w2) and the gradients of ``sum(out2^2)`` with
    respect to every parameter, under jit."""

    def steps(p):
        out1, w1 = jlayer.apply(p, jg, x)
        out2, w2 = jlayer.apply(p, jg, x, weight=w1)
        return (out2 ** 2).sum(), (out1, w1, out2, w2)

    (_, outs), grads = jax.jit(jax.value_and_grad(steps, has_aux=True))(params)
    return [np.asarray(o) for o in outs], evolvegcn_params_from_jax(_np(grads))


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "padded"])
@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("variant", ["o", "h"])
def test_layer_steps_and_gradients_match_jax(data, variant, impl, padded):
    edges, x = data
    jg, g = _graphs(edges, 64 if padded else 8)
    assert (g.fwd_csr.capacity > E) is padded
    jlayer, params, layer = _pair(variant, jg, x, impl)
    ref, ref_grads = _jax_two_steps(jlayer, params, jg, jnp.asarray(x))
    xt = torch.from_numpy(x)
    out1, w1 = layer(g, xt)
    out2, w2 = layer(g, xt, weight=w1)
    for name, got, want in zip(("out1", "w1", "out2", "w2"), (out1, w1, out2, w2), ref):
        np.testing.assert_allclose(got.detach().numpy(), want, err_msg=name, **VALUE)
    (out2 ** 2).sum().backward()
    grads = {k: p.grad for k, p in layer.named_parameters()}
    assert set(grads) == set(ref_grads) and all(v is not None for v in grads.values())
    for k, v in grads.items():
        np.testing.assert_allclose(v.numpy(), ref_grads[k].numpy(), err_msg=k, **GRAD)


@pytest.mark.parametrize("variant", ["o", "h"])
def test_forward_and_weight_evolution(data, variant):
    """``tests/test_evolvegcn.py``'s check on the port: shapes, weights that
    change from step to step, finite outputs."""
    edges, x = data
    _, g = _graphs(edges, 8)
    layer = VARIANTS[variant][1](F, OUT, device="cpu", generator=torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x)
    out1, w1 = layer(g, xt)
    assert out1.shape == (N, OUT) and w1.shape == (F, OUT)
    out2, w2 = layer(g, xt, weight=w1)
    assert not np.allclose(w1.detach().numpy(), w2.detach().numpy())
    assert torch.isfinite(out2).all()


def test_grad_flows_through_evolution(data):
    edges, x = data
    _, g = _graphs(edges, 8)
    layer = EvolveGCNO(F, OUT, device="cpu", generator=torch.Generator().manual_seed(0))
    xt = torch.from_numpy(x)
    out, w = layer(g, xt)
    out2, _ = layer(g, xt, weight=w)
    (out2 ** 2).sum().backward()
    assert sum(p.grad.abs().sum().item() for p in layer.parameters()) > 0
    assert layer.weight.grad.abs().sum() > 0  # through both GRU steps


def test_top_rows_break_ties_as_lax_top_k():
    """Equal scores go to the lower index, largest first, as ``lax.top_k``
    orders them (torch.topk promises no order among ties)."""
    y = np.array([0.5, 2.0, -1.0, 2.0, 0.5, 0.5, 3.0, 2.0, -1.0, 0.5], np.float32)
    for k in (1, 3, 4, 7, 10):
        _, want = jax.lax.top_k(jnp.asarray(y), k)
        np.testing.assert_array_equal(_top_rows(torch.from_numpy(y), k).numpy(), np.asarray(want))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_h_variant_with_duplicated_rows_matches_jax(data, impl):
    """Rows duplicated across the graph tie in score; their summaries are
    equal, so the output does not depend on which of a tied pair is taken."""
    edges, x = data
    x = np.concatenate([x[: N // 2], x[: N // 2]])
    jg, g = _graphs(edges, 8)
    jlayer, params, layer = _pair("h", jg, x, impl)
    ref, _ = _jax_two_steps(jlayer, params, jg, jnp.asarray(x))
    out1, w1 = layer(g, torch.from_numpy(x))
    np.testing.assert_allclose(out1.detach().numpy(), ref[0], **VALUE)
    np.testing.assert_allclose(w1.detach().numpy(), ref[1], **VALUE)


def test_h_variant_refuses_fewer_nodes_than_outputs():
    rng = np.random.default_rng(1)
    n = OUT - 1
    edges = [(int(s), int(d)) for s, d in zip(rng.integers(0, n, 30), rng.integers(0, n, 30))]
    x = rng.standard_normal((n, F)).astype(np.float32)
    jg = JaxStaticGraph(edges, None, n)
    with pytest.raises(Exception):
        jax.jit(lambda k, x: JaxEvolveGCNH(F, OUT).init(k, jg, x))(jax.random.key(0), jnp.asarray(x))
    layer = EvolveGCNH(F, OUT, device="cpu")
    with pytest.raises(ValueError, match="summarizes"):
        layer(StaticGraph(edges, None, n, device="cpu"), torch.from_numpy(x))


# -- the driver -----------------------------------------------------------------

DRIVER = dict(cutoff=20, lags=8, hidden=8, epochs=2, lr=1e-2)


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    """Both packages' loaders offline, the port's cache in a fresh HOME."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("HOME", str(tmp_path_factory.mktemp("home")))
        mp.setattr(JaxDataset, "_offline", True)
        mp.setattr(JaxDataset, "_save_dataset", lambda self: None)
        mp.setattr(STGraphDataset, "_offline", True)
        yield


def _jax_epochs(variant, c):
    """``train.py``'s recipe (lines 78-100) on WikiMath: the initial
    parameters, each epoch's loss and gradients, and the parameters after
    the last Adam step."""
    d = JD.WikiMathDataLoader(lags=c["lags"], cutoff_time=c["cutoff"])
    n = d.gdata["num_nodes"]
    g = JaxStaticGraph(d.get_edges(), d.get_edge_weights(), n)
    targets = np.stack(d.get_all_targets()).astype(np.float32)
    t_steps = targets.shape[0] - c["lags"]
    feats = jnp.asarray(np.stack([targets[i:i + c["lags"]].T for i in range(t_steps)]))
    ys = jnp.asarray(targets[c["lags"]:])
    conv = VARIANTS[variant][0](c["lags"], c["hidden"])
    head = fnn.Dense(1)
    params = jax.jit(lambda k, x: conv.init(k, g, x))(jax.random.key(0), feats[0])
    hp = jax.jit(head.init)(jax.random.key(1), jnp.zeros((n, c["hidden"])))
    opt = optax.adam(c["lr"])

    @jax.jit
    def epoch(ps, opt_state):
        def loss_fn(ps):
            params, hp = ps

            def body(w, xy):
                out, w = conv.apply(params, g, xy[0], weight=w)
                return w, jnp.mean((head.apply(hp, jax.nn.relu(out))[:, 0] - xy[1]) ** 2)

            return jax.lax.scan(body, params["params"]["weight"], (feats, ys))[1].mean()

        loss, grads = jax.value_and_grad(loss_fn)(ps)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(ps, updates), opt_state, loss, grads

    def state(ps):
        return evolvegcn_params_from_jax(_np(ps[0])), linear_params_from_jax(_np(ps[1]))

    ps = (params, hp)
    init, opt_state, records = state(ps), opt.init(ps), []
    for _ in range(c["epochs"]):
        ps, opt_state, loss, grads = epoch(ps, opt_state)
        records.append((float(loss), state(grads)))
    return t_steps, init, records, state(ps)


@pytest.mark.parametrize("variant", ["o", "h"])
def test_driver_epochs_match_jax(offline, variant):
    c = DRIVER
    t_steps, init, records, final = _jax_epochs(variant, c)
    d = EV.load_evolvegcn_dataset("wikimath", c["lags"], c["cutoff"])
    tr = EV.EvolveGCNTrainer(d, variant, c["lags"], c["hidden"], c["lr"], impl="dense", device="cpu")
    assert tr.total == t_steps == 12
    tr.conv.load_state_dict(init[0])
    tr.head.load_state_dict(init[1])
    for epoch, (ref_loss, (ref_conv, ref_head)) in enumerate(records):
        loss, _ = tr.backward()
        np.testing.assert_allclose(loss.item(), ref_loss, err_msg=f"epoch {epoch}", **LOSS)
        for mod, ref in ((tr.conv, ref_conv), (tr.head, ref_head)):
            for k, p in mod.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=f"epoch {epoch} {k}", **GRAD)
        tr.opt.step()
    for mod, ref in zip((tr.conv, tr.head), final):
        for k, v in mod.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), err_msg=k, **PARAM)


def test_driver_kernel_route_follows_the_dense_route(offline):
    """The driver's ``--impl kernel`` (K1 and K2's plain versions on the
    CPU) gives the dense route's losses over two epochs from one seed."""
    c = DRIVER
    d = EV.load_evolvegcn_dataset("wikimath", c["lags"], c["cutoff"])
    losses = {impl: [EV.EvolveGCNTrainer(d, "h", c["lags"], c["hidden"], impl=impl, device="cpu", seed=3)]
              for impl in ("dense", "kernel")}
    for impl, (tr,) in losses.items():
        losses[impl] = [tr.epoch().item() for _ in range(c["epochs"])]
    np.testing.assert_allclose(losses["kernel"], losses["dense"], **LOSS)


def test_driver_main_prints_the_scripts_table(offline, capsys):
    r = EV.main(["--variant", "o", "--dataset", "windmill_large", "--num_epochs", "4", "--num_hidden", "4",
                 "--feat_size", "4", "--cutoff_time", "12", "--cpu"])
    out = capsys.readouterr().out
    assert len(r["mse"]) == 4 and np.isfinite(r["mse"]).all() and r["timesteps"] == 8
    assert "EvolveGCN-O windmill_large" in out and f"^^^0^^^{r['avg_epoch_s']:.6f}" in out
    with pytest.raises(ValueError, match="unknown dataset"):
        EV.load_evolvegcn_dataset("wiki", 4, 12)
