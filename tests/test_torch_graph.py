"""The port's CSR, StaticGraph and symmetric_norm against the JAX package.

Graph structure is integer data, so every array must be equal exactly.
"""

import numpy as np
import pytest

from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.graph.static_graph import StaticGraph as JaxStaticGraph
from stgraph_tpu.utils.norm import symmetric_norm as jax_symmetric_norm
from stgraph_tpu_torch import native
from stgraph_tpu_torch.graph.csr import build_csr, pad_edges, round_up
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.ops.spmm_kernels import k1_work_items
from stgraph_tpu_torch.utils.norm import symmetric_norm
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _graph(rng, n=50, e=180, isolated=0, duplicates=0):
    src = rng.integers(0, n - isolated, e)
    dst = rng.integers(0, n - isolated, e)
    if duplicates:
        src = np.concatenate([src, src[:duplicates]])
        dst = np.concatenate([dst, dst[:duplicates]])
    return src, dst


def _assert_same_csr(port, ref):
    for a, b in zip(port.host_arrays(), ref.host_arrays()):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert port.num_nodes == ref.num_nodes
    assert port.num_edges == int(ref.num_edges)
    assert port.capacity == ref.capacity
    np.testing.assert_array_equal(port.indptr.numpy(), np.asarray(ref.indptr))
    np.testing.assert_array_equal(port.cols.numpy(), np.asarray(ref.cols))


GRAPHS = [
    dict(n=50, e=180),
    dict(n=50, e=30, capacity=64),  # capacity padding
    dict(n=60, e=200, isolated=10),  # isolated nodes
    dict(n=40, e=100, duplicates=25),  # duplicate edges
    dict(n=300, e=3000, capacity=3005),
]


@pytest.mark.parametrize("spec", GRAPHS, ids=lambda s: "-".join(f"{k}{v}" for k, v in s.items()))
def test_build_csr_and_transpose_match_jax(rng, spec):
    spec = dict(spec)
    cap = spec.pop("capacity", None)
    n = spec["n"]
    src, dst = _graph(rng, **spec)
    port = build_csr(src, dst, n, capacity=cap, device="cpu")
    ref = jax_build_csr(src, dst, n, capacity=cap)
    _assert_same_csr(port, ref)
    _assert_same_csr(port.transpose(), ref.transpose())
    np.testing.assert_array_equal(port.degrees().numpy(), np.asarray(ref.degrees()))
    np.testing.assert_array_equal(port.col_degrees().numpy(), np.asarray(ref.col_degrees()))
    np.testing.assert_array_equal(port.edge_mask.numpy(), np.asarray(ref.edge_mask))


def test_numpy_path_equals_native_path(rng, monkeypatch):
    src, dst = _graph(rng, n=80, e=400, duplicates=40)
    built = build_csr(src, dst, 80, capacity=448, device="cpu")
    monkeypatch.setattr(native, "build_csr_arrays", lambda *a: None)
    fallback = build_csr(src, dst, 80, capacity=448, device="cpu")
    for a, b in zip(built.host_arrays(), fallback.host_arrays()):
        np.testing.assert_array_equal(a, b)


def test_pad_edges_and_round_up():
    psrc, pdst, peid = pad_edges(np.array([1, 2]), np.array([0, 0]), 5, 4)
    np.testing.assert_array_equal(psrc, [1, 2, 5, 5])
    np.testing.assert_array_equal(peid, [0, 1, 4, 4])
    assert round_up(9, 8) == 16 and round_up(8, 8) == 8
    with pytest.raises(ValueError):
        pad_edges(np.arange(5), np.arange(5), 5, 4)


@pytest.mark.parametrize("weighted", [False, True])
def test_static_graph_matches_jax(rng, weighted):
    n, e = 60, 240
    src, dst = _graph(rng, n=n, e=e, isolated=5)
    edges = np.stack([src, dst], 1)
    w = rng.random(e).astype(np.float32) if weighted else None
    port = StaticGraph(edges, w, n, device="cpu")
    ref = JaxStaticGraph(edges, w, n)
    _assert_same_csr(port.fwd_csr, ref.fwd_csr)
    _assert_same_csr(port.bwd_csr, ref.bwd_csr)
    np.testing.assert_array_equal(port.in_degrees(), ref.in_degrees())
    np.testing.assert_array_equal(port.out_degrees(), ref.out_degrees())
    np.testing.assert_allclose(port.weighted_in_degrees(), ref.weighted_in_degrees(), rtol=1e-12)
    assert port.get_num_nodes() == n and port.get_num_edges() == e
    assert port.graph_type() == "csr"
    # f32 norms from the same integer degrees: equal to the last bit
    np.testing.assert_array_equal(symmetric_norm(port).numpy(), jax_symmetric_norm(ref))


def test_static_graph_takes_a_list_of_pairs(rng):
    src, dst = _graph(rng, n=30, e=90)
    pairs = [(int(s), int(d)) for s, d in zip(src, dst)]
    a = StaticGraph(pairs, None, 30, device="cpu")
    b = StaticGraph(np.stack([src, dst], 1), None, 30, device="cpu")
    _assert_same_csr(a.fwd_csr, b.fwd_csr)


@pytest.mark.parametrize("sort", ["native", "lexsort"])
def test_build_csr_refuses_out_of_range_ids(monkeypatch, sort):
    """An id outside [0, num_nodes) raises ``ValueError`` before the sort:
    the native counting sort would index its counts with it."""
    if sort == "lexsort":
        monkeypatch.setattr(native, "build_csr_arrays", lambda *a: None)
    for src, dst in (([0, 5], [1, 2]), ([0, 1], [-1, 2]), ([3, 1], [0, 2])):
        with pytest.raises(ValueError, match="out of range"):
            build_csr(src, dst, 3, device="cpu")


def test_csr_to_device_is_identity_on_same_device(rng):
    src, dst = _graph(rng)
    c = build_csr(src, dst, 50, device="cpu")
    assert c.to("cpu") is c
    assert isinstance(c.host_arrays()[0], np.ndarray)
    assert c.cols_clamped.max().item() == 49


@pytest.mark.parametrize("chunk", [1, 4, 64])
def test_k1_work_items_cover_every_edge_once(rng, chunk):
    src, dst = _graph(rng, n=70, e=600, isolated=7)
    dst[:80] = 3  # one hub row
    c = build_csr(src, dst, 70, device="cpu")
    indptr = c.host_arrays()[0]
    item_row, item_beg, split_rows = k1_work_items(indptr, chunk)
    seen = np.zeros(indptr[-1], np.int64)
    for r, b in zip(item_row, item_beg):
        end = min(b + chunk, indptr[r + 1])
        assert indptr[r] <= b <= indptr[r + 1]
        seen[b:end] += 1
    np.testing.assert_array_equal(seen, 1)
    deg = np.diff(indptr)
    # every row has an item (empty rows write their zero), hubs several
    np.testing.assert_array_equal(np.bincount(item_row, minlength=70), np.maximum(1, -(-deg // chunk)))
    np.testing.assert_array_equal(split_rows, np.flatnonzero(deg > chunk))
