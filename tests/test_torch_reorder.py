"""The gather-locality reorder (``graph.reorder``, ``native.reorder_locality``
and ``OgbNodeDataLoader(reorder=True)``) against the JAX package's, on
small graphs: orders, relabelled edges, working sets and the loader's
arrays element for element, by the native path and the numpy path."""

import numpy as np
import pytest

from stgraph_tpu import native as jax_native
from stgraph_tpu.dataset.ogb_dataloader import OgbNodeDataLoader as JaxOgb
from stgraph_tpu.graph import reorder as jax_reorder
from stgraph_tpu_torch import native
from stgraph_tpu_torch.dataset import OgbNodeDataLoader
from stgraph_tpu_torch.graph import locality_order, relabel_edges
from stgraph_tpu_torch.graph import reorder
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _community_graph(rng, n=3000, e=30_000, k=24, p_intra=0.85):
    """A block model with shuffled ids, a hub, self loops, repeated edges,
    isolated nodes and out-of-range endpoints (which both passes drop)."""
    comm = rng.integers(0, k, n - 40)  # the last 40 nodes stay isolated
    n_intra = int(e * p_intra)
    cs = rng.integers(0, k, n_intra)
    members = [np.flatnonzero(comm == c) for c in range(k)]
    src = np.concatenate([rng.choice(members[c], np.sum(cs == c)) for c in range(k)])
    dst = np.concatenate([rng.choice(members[c], np.sum(cs == c)) for c in range(k)])
    src = np.concatenate([src, rng.integers(0, n - 40, e - src.size)])
    dst = np.concatenate([dst, rng.integers(0, n - 40, e - dst.size)])
    src[:300] = 7  # a hub
    src[300:320] = dst[300:320]  # self loops
    src[320:340], dst[320:340] = src[340:360], dst[340:360]  # repeated edges
    src[360], dst[361] = -1, n  # out of range
    return src.astype(np.int32), dst.astype(np.int32), n


@pytest.fixture(scope="module")
def graph():
    return _community_graph(np.random.default_rng(0))


def _native_available():
    if not native.available():
        pytest.fail("the port's native builder did not build (g++ is expected here)")
    if jax_native.reorder_locality(np.zeros(1, np.int32), np.zeros(1, np.int32), 1) is None:
        pytest.fail("the JAX package's native reorder_locality is not available here")


def test_native_order_matches_jax(graph):
    _native_available()
    src, dst, n = graph
    got = native.reorder_locality(src, dst, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_native.reorder_locality(src, dst, n))
    np.testing.assert_array_equal(locality_order(src, dst, n), jax_reorder.locality_order(src, dst, n))


@pytest.mark.parametrize("rounds", [1, 8])
def test_numpy_order_matches_jax(graph, rounds):
    src, dst, n = graph
    got = reorder._lp_order_numpy(src, dst, n, rounds)
    np.testing.assert_array_equal(got, jax_reorder._lp_order_numpy(src, dst, n, rounds))
    assert np.array_equal(np.sort(got), np.arange(n))


def test_native_and_numpy_agree(graph):
    _native_available()
    src, dst, n = graph
    np.testing.assert_array_equal(native.reorder_locality(src, dst, n), reorder._lp_order_numpy(src, dst, n))
    empty = np.empty(0, np.int32)
    np.testing.assert_array_equal(native.reorder_locality(empty, empty, 5), np.arange(5))
    assert reorder._lp_order_numpy(empty, empty, 0).shape == (0,)


def test_locality_order_takes_numpy_without_the_native_builder(graph, monkeypatch):
    src, dst, n = graph
    monkeypatch.setattr(native, "reorder_locality", lambda *a: None)
    np.testing.assert_array_equal(locality_order(src, dst, n), jax_reorder._lp_order_numpy(src, dst, n))


def test_relabel_and_working_set_match_jax(graph):
    src, dst, n = graph
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    src, dst = src[keep], dst[keep]
    order = reorder._lp_order_numpy(src, dst, n)
    np.testing.assert_array_equal(reorder.inverse_permutation(order), jax_reorder.inverse_permutation(order))
    s2, d2 = relabel_edges(src, dst, order)
    js2, jd2 = jax_reorder.relabel_edges(src, dst, order)
    np.testing.assert_array_equal(s2, js2)
    np.testing.assert_array_equal(d2, jd2)
    np.testing.assert_array_equal(order[s2], src)  # new ids map back to the old
    for region, row in [(2048, 256), (1 << 20, 512)]:
        before = reorder.gather_working_set(dst, src, n, region, row)
        after = reorder.gather_working_set(d2, s2, n, region, row)
        assert before == jax_reorder.gather_working_set(dst, src, n, region, row)
        assert after == jax_reorder.gather_working_set(d2, s2, n, region, row)
    assert reorder.gather_working_set(d2, s2, n, 2048, 256) < reorder.gather_working_set(dst, src, n, 2048, 256) / 2
    assert reorder.gather_working_set(np.empty(0), np.empty(0), 0) == 0.0


def test_ogb_loader_reorder_matches_jax(tmp_path):
    port = OgbNodeDataLoader(root=str(tmp_path / "a"), scale=0.0002, seed=5, reorder=True)
    ref = JaxOgb(root=str(tmp_path / "b"), scale=0.0002, seed=5, reorder=True)
    base = OgbNodeDataLoader(root=str(tmp_path / "c"), scale=0.0002, seed=5)
    assert port.gdata == ref.gdata
    np.testing.assert_array_equal(port.node_order, ref.node_order)
    np.testing.assert_array_equal(port.get_edge_index(), ref.get_edge_index())
    np.testing.assert_array_equal(port.get_all_features(), ref.get_all_features())
    np.testing.assert_array_equal(port.get_all_targets(), ref.get_all_targets())
    order = port.node_order
    n = port.gdata["num_nodes"]
    assert np.array_equal(np.sort(order), np.arange(n))
    np.testing.assert_array_equal(order[port.get_edge_index()], base.get_edge_index())
    np.testing.assert_array_equal(port.get_all_features(), base.get_all_features()[order])
    np.testing.assert_array_equal(port.get_all_targets(), base.get_all_targets()[order])
