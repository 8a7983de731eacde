"""The serving slice as a whole: the port's GCNConv, a 3-layer GCN with
parameters carried over by ``convert.py``, ``Predictor`` and the OGB loader,
against the JAX package on the same numpy inputs.

Tolerances: f32 runs do the same arithmetic with sums in another order
(1e-5); bf16 runs round at other places (the JAX ``jnp`` path sums in bf16,
the port's kernel path in f32), which a bf16 ulp per rounding covers at
these row sizes (2e-2).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgraph_tpu.dataset.ogb_dataloader import OgbNodeDataLoader as JaxOgb
from stgraph_tpu.graph.static_graph import StaticGraph as JaxStaticGraph
from stgraph_tpu.nn.gcn_conv import GCNConv as JaxGCNConv
from stgraph_tpu_torch.convert import gcn_params_from_jax
from stgraph_tpu_torch.dataset import OgbNodeDataLoader
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import GCNConv
from stgraph_tpu_torch.serve import Predictor

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

IMPLS = [("torch", "jnp"), ("dense", "dense"), ("kernel", "jnp"), ("kernel", "dense")]


def _graphs(rng, n=120, e=700):
    src = rng.integers(0, n - 6, e)  # isolated nodes at the end
    dst = rng.integers(0, n - 6, e)
    edges = np.stack([src, dst], 1)
    return StaticGraph(edges, None, n, device="cpu"), JaxStaticGraph(edges, None, n)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
@pytest.mark.parametrize("variant", ["unweighted", "weighted", "bf16"])
def test_gcnconv_matches_jax(rng, impl, jimpl, variant):
    g, jg = _graphs(rng)
    n, fin, fout = 120, 47, 16
    x = rng.standard_normal((n, fin)).astype(np.float32)
    ew = rng.random(g.get_num_edges()).astype(np.float32) if variant == "weighted" else None
    dtype = variant == "bf16"
    jconv = JaxGCNConv(fin, fout, impl=jimpl, dtype=jnp.bfloat16 if dtype else None)
    # jit, as the JAX package runs: its eager jnp path indexes host numpy
    # with the padding sentinel
    params = jax.jit(lambda k, h: jconv.init(k, jg, h))(jax.random.key(0), jnp.asarray(x))
    apply = jax.jit(lambda p, h, w: jconv.apply(p, jg, h, w))
    ref = apply(params, jnp.asarray(x), None if ew is None else jnp.asarray(ew))

    conv = GCNConv(fin, fout, impl=impl, dtype=torch.bfloat16 if dtype else None, device="cpu")
    conv.load_state_dict(gcn_params_from_jax(_numpy_tree(params)))
    out = conv(g, torch.from_numpy(x), None if ew is None else torch.from_numpy(ew))
    assert out.dtype == (torch.bfloat16 if dtype else torch.float32)
    np.testing.assert_allclose(
        out.detach().float().numpy(), np.asarray(ref, np.float32), **(BF16 if dtype else F32)
    )


def test_gcnconv_init_is_xavier_uniform_with_zero_bias():
    gen = torch.Generator().manual_seed(3)
    conv = GCNConv(100, 128, device="cpu", generator=gen)
    bound = np.sqrt(6.0 / (100 + 128))
    w = conv.weight.detach().numpy()
    assert w.shape == (100, 128) and np.abs(w).max() <= bound
    assert np.abs(w).max() > 0.9 * bound
    assert not conv.bias.detach().any()
    same = GCNConv(100, 128, device="cpu", generator=torch.Generator().manual_seed(3))
    assert torch.equal(same.weight, conv.weight)


class _JaxGCN(fnn.Module):
    graph: object
    dims: tuple
    impl: str

    @fnn.compact
    def __call__(self, h):
        for i, (a, b) in enumerate(zip(self.dims[:-1], self.dims[1:])):
            last = i == len(self.dims) - 2
            h = JaxGCNConv(a, b, activation=None if last else jax.nn.relu, impl=self.impl)(self.graph, h)
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


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_three_layer_gcn_and_predictor_match_jax(rng, impl, jimpl):
    g, jg = _graphs(rng, n=200, e=2400)
    dims = (100, 32, 32, 47)  # ogbn-products' in/out widths, narrow hidden
    x = rng.standard_normal((200, 100)).astype(np.float32)
    jmodel = _JaxGCN(jg, dims, jimpl)
    params = jax.jit(jmodel.init)(jax.random.key(1), jnp.asarray(x))
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(x)))

    model = _GCN(g, dims, impl)
    state = gcn_params_from_jax(_numpy_tree(params))
    assert sorted(state) == sorted(model.state_dict())
    model.load_state_dict(state)
    out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), ref, **F32)

    predictor = Predictor.build(model, dict(model.state_dict()), (torch.from_numpy(x),), device="cpu")
    x2 = rng.standard_normal((200, 100)).astype(np.float32)
    served = predictor(torch.from_numpy(x2))
    assert torch.equal(served, model(torch.from_numpy(x2)).detach())
    assert not served.requires_grad and predictor.cost_analysis is None


def test_predictor_takes_a_plain_function(tmp_path):
    def apply_fn(p, x):
        return x @ p["w"]

    pred = Predictor.build(apply_fn, {"w": torch.eye(3)}, (torch.ones(2, 3),), device="cpu")
    assert torch.equal(pred(torch.ones(2, 3)), torch.ones(2, 3))
    with pytest.raises(FileNotFoundError):  # an empty checkpoint directory, as in JAX
        Predictor.from_checkpoint(str(tmp_path), apply_fn, {"w": torch.eye(3)}, (torch.ones(2, 3),), device="cpu")


def test_convert_rejects_other_trees():
    with pytest.raises(ValueError):
        gcn_params_from_jax({"params": {"Dense_0": {"kernel": np.zeros((2, 2))}}})
    with pytest.raises(ValueError):
        gcn_params_from_jax({"params": {"GCNConv_1": {"weight": np.zeros((2, 2))}}})


def test_synthetic_ogb_loader_matches_jax(tmp_path):
    port = OgbNodeDataLoader(root=str(tmp_path / "a"), scale=0.0002, seed=5)
    ref = JaxOgb(root=str(tmp_path / "b"), scale=0.0002, seed=5)
    assert port.synthetic and ref.synthetic
    assert port.gdata == ref.gdata
    np.testing.assert_array_equal(port.get_edge_index(), ref.get_edge_index())
    np.testing.assert_array_equal(port.get_edges(), ref.get_edges())
    np.testing.assert_array_equal(port.get_all_features(), ref.get_all_features())
    np.testing.assert_array_equal(port.get_all_targets(), ref.get_all_targets())
    with pytest.raises(NotImplementedError):
        OgbNodeDataLoader(root=str(tmp_path), scale=0.0002, reorder=True)
