"""The dynamic-graph slice against the JAX package on the same numpy inputs:
the delta preprocessing, the delta and naive graphs, the lazy store and its
compaction (array for array), K6's and K7's plain versions against the
Pallas kernels in interpret mode, ``lazy_spmm`` and its gradient,
``lazy_norm``, ``GCNConv`` on a pair, three timesteps of TGCN link
prediction on a pair, and the synthetic England-COVID.

Tolerances: store layouts, counts and logs are exact (both packages sort,
bisect and rank the same keys); weights to 1e-6, they are copied, never
summed. K6 and the aggregations in f32 sum in another order than the TPU
kernel's MXU dots: 1e-5. K7's counts are exact; its weight sums 1e-5.
TGCN: loss and gradients to 1e-4 relative and 1e-5 absolute, three
timesteps of three gates each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgraph_tpu.dataset.base import STGraphDataset as JaxDataset
from stgraph_tpu.dataset.england_covid_dataloader import EnglandCovidDataLoader as JaxEngland
from stgraph_tpu.graph import delta_graph as JD
from stgraph_tpu.graph.dynamic_graph import preprocess_deltas as jax_preprocess_deltas
from stgraph_tpu.graph.lazy_store import compact as jax_compact
from stgraph_tpu.graph.naive_graph import NaiveGraph as JaxNaiveGraph
from stgraph_tpu.nn.tgcn import TGCN as JaxTGCN
from stgraph_tpu.ops import dyn_spmm as JDS
from stgraph_tpu.ops.segment_pallas import EDGE_CHUNK as JAX_EDGE_CHUNK
from stgraph_tpu.ops.segment_pallas import spmm_rowid_traced
from stgraph_tpu_torch.convert import lazy_pair_from_jax, tgcn_params_from_jax
from stgraph_tpu_torch.dataset import EnglandCovidDataLoader, STGraphDataset
from stgraph_tpu_torch.graph import DeltaGraph, NaiveGraph, StaticGraph, apply_delta, compact
from stgraph_tpu_torch.graph.delta_graph import EdgeStore, edge_store_to_csr
from stgraph_tpu_torch.graph.dynamic_graph import preprocess_deltas
from stgraph_tpu_torch.nn import TGCN, GCNConv
from stgraph_tpu_torch.ops import dyn_spmm as DS
from stgraph_tpu_torch.ops import rowid_kernels as RK

N, CAP, TCAP, D = 120, 1024, 64, 16  # a compaction every 4 steps
F32 = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _edge_lists(rng, n, e, steps, churn, weighted):
    """Per-timestamp unique (src, dst) lists with churn, and stable per-key
    weights (a changed weight on a persisting edge now and then)."""
    keys = rng.choice(n * n, e, replace=False)
    lists, weights = [], []
    for t in range(steps):
        if t:
            keep = rng.permutation(len(keys))[churn:]
            keys = np.unique(np.concatenate([keys[keep], rng.choice(n * n, churn, replace=False)]))
        edges = np.stack([keys // n, keys % n], 1)
        lists.append(edges)
        w = ((keys * 2654435761) % 997 / 997.0 + 0.25).astype(np.float32)
        w[rng.random(len(w)) < 0.05] += 1.0  # weight updates
        weights.append(w)
    return lists, (weights if weighted else None)


@pytest.mark.parametrize("weighted", [False, True])
def test_preprocess_deltas_matches_jax(rng, weighted):
    lists, weights = _edge_lists(rng, 50, 300, 5, 40, weighted)
    ours, ref = preprocess_deltas(lists, weights), jax_preprocess_deltas(lists, weights)
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("weighted", [False, True])
def test_delta_graph_snapshots_and_csrs_match_jax(rng, weighted):
    lists, weights = _edge_lists(rng, 60, 400, 4, 50, weighted)
    ours = DeltaGraph(lists, weights, device="cpu")
    ref = JD.DeltaGraph(lists, weights)
    for a, b in zip(ours.staged_deltas(), ref.staged_deltas()):
        np.testing.assert_array_equal(_np(a), _np(b))
    if weighted:
        np.testing.assert_array_equal(_np(ours.staged_add_weights()), _np(ref.staged_add_weights()))
    for t in range(-1, 4):
        a, b = ours.snapshot_store(t), ref.snapshot_store(t)
        np.testing.assert_array_equal(a.rows, b.rows)
        np.testing.assert_array_equal(a.cols, b.cols)
        assert int(a.num_edges) == int(b.num_edges)
        if weighted:
            np.testing.assert_array_equal(a.weights, b.weights)
    for t in range(4):
        ca, cb = ours.get_graph(t), ref.get_graph(t)
        for x, y in zip(ca.host_arrays(), (cb.indptr, cb.rows, cb.cols, cb.eids)):
            np.testing.assert_array_equal(x, _np(y))
        np.testing.assert_array_equal(ours.get_backward_graph(t).host_arrays()[0], _np(ref.get_backward_graph(t).indptr))
        if weighted:
            np.testing.assert_array_equal(_np(ours.get_edge_weights(t)), ref.get_edge_weights(t))


@pytest.mark.parametrize("weighted", [False, True])
def test_apply_delta_on_the_device_matches_jax(rng, weighted):
    lists, weights = _edge_lists(rng, 60, 400, 3, 50, weighted)
    g = JD.DeltaGraph(lists, weights)
    add, dele = (np.asarray(x) for x in g.staged_deltas())
    aw = None if not weighted else np.asarray(g.staged_add_weights())
    s0 = g.snapshot_store(-1)
    n = s0.num_nodes

    @jax.jit
    def jstep(rows, cols, ws, *args, add_weights=None):
        out = JD.apply_delta(JD.EdgeStore(rows, cols, jnp.int32(0), n, ws), *args, add_weights=add_weights)
        return out.rows, out.cols, out.weights, out.num_edges

    jrows, jcols, jw = s0.rows, s0.cols, s0.weights
    store = EdgeStore(_t(s0.rows), _t(s0.cols), _t(s0.num_edges), n, None if s0.weights is None else _t(s0.weights))
    for t in range(3):
        args = (add[t, :, 1], add[t, :, 0], dele[t, :, 1], dele[t, :, 0])
        jrows, jcols, jw, jne = jstep(jrows, jcols, jw, *args, add_weights=None if aw is None else aw[t])
        store = apply_delta(store, *(_t(a) for a in args), add_weights=None if aw is None else _t(aw[t]))
        np.testing.assert_array_equal(_np(store.rows), _np(jrows))
        np.testing.assert_array_equal(_np(store.cols), _np(jcols))
        assert int(store.num_edges) == int(jne) == len(lists[t])
        if weighted:
            np.testing.assert_array_equal(_np(store.weights), _np(jw))
    csr = edge_store_to_csr(store, device="cpu")
    ref = JD.edge_store_to_csr(JD.EdgeStore(_np(jrows), _np(jcols), _np(jne), n, None))
    np.testing.assert_array_equal(csr.host_arrays()[0], _np(ref.indptr))


@pytest.mark.parametrize("weighted", [False, True])
def test_naive_graph_matches_jax(rng, weighted):
    lists, weights = _edge_lists(rng, 40, 200, 3, 30, weighted)
    ours, ref = NaiveGraph(lists, weights, device="cpu"), JaxNaiveGraph(lists, weights)
    assert ours.get_num_nodes() == ref.get_num_nodes() and ours.get_num_edges() == ref.get_num_edges()
    for t in range(3):
        a, b = ours.get_graph(t), ref.get_graph(t)
        for x, y in zip(a.host_arrays(), (b.indptr, b.rows, b.cols, b.eids)):
            np.testing.assert_array_equal(x, _np(y))
        bt = ref.get_backward_graph(t)
        for x, y in zip(ours.get_backward_graph(t).host_arrays(), (bt.indptr, bt.rows, bt.cols, bt.eids)):
            np.testing.assert_array_equal(x, _np(y))
        if weighted:
            np.testing.assert_array_equal(_np(ours.get_edge_weights(t)), _np(ref.get_edge_weights(t)))


def _stream(rng, live, steps, weighted):
    """(adds, dels, add_w) batches of width D in (src, dst) order, keeping
    the contract: deletions name live edges (half of them added in the step
    before, so tail-resident), additions are new or, weighted, a weight
    update paired with a delete of the same key."""
    batches, recent = [], []
    for _ in range(steps):
        order = sorted(live)
        pool = [k for k in recent if k in live][: D // 2]
        pool += [order[i] for i in rng.permutation(len(order)) if order[i] not in pool][: D - 3 - len(pool)]
        dels = pool
        for k in dels:
            live.pop(k)
        updates = []
        if weighted:  # two weight updates: delete + re-add of a live key
            updates = [k for k in sorted(live)[::7] if k not in dels][:2]
        adds = list(updates)
        while len(adds) < D - 2:
            k = int(rng.integers(0, N * N))
            if k not in live and k not in adds and k not in dels:
                adds.append(k)
        a = np.full((D, 2), N, np.int32)
        dl = np.full((D, 2), N, np.int32)
        aw = np.zeros(D, np.float32)
        for i, k in enumerate(adds):
            a[i] = divmod(k, N)
            aw[i] = 0.5 + rng.random()
            live[k] = float(aw[i]) if weighted else 1.0
        for i, k in enumerate(dels + updates):
            dl[i] = divmod(k, N)
        batches.append((a, dl, aw if weighted else None))
        recent = adds
    return batches


def _initial(rng, weighted, e=300):
    keys = rng.choice(N * N, e, replace=False)
    src, dst = (keys // N).astype(np.int64), (keys % N).astype(np.int64)
    w = (0.5 + rng.random(e)).astype(np.float32) if weighted else None
    live = {int(k): (1.0 if w is None else float(w[i])) for i, k in enumerate(keys)}
    return src, dst, w, live


_jax_step = jax.jit(JDS.apply_delta_lazy_pair)


def _replay(rng, weighted, steps):
    """The same delta stream through both packages from one initial state."""
    src, dst, w, live = _initial(rng, weighted)
    jpair = JDS.lazy_pair_from_edges(src, dst, N, CAP, TCAP, weights=w)
    pair = lazy_pair_from_jax(jax.tree_util.tree_map(np.asarray, jpair), device="cpu")
    batches = _stream(rng, live, steps, weighted)
    pairs = []
    for a, dl, aw in batches:
        jpair = _jax_step(jpair, a[:, 0], a[:, 1], dl[:, 0], dl[:, 1],
                          add_weights=None if aw is None else jnp.asarray(aw))
        pair = DS.apply_delta_lazy_pair(pair, _t(a[:, 0]), _t(a[:, 1]), _t(dl[:, 0]), _t(dl[:, 1]),
                                        add_weights=None if aw is None else _t(aw))
        pairs.append((pair, jpair))
    return pairs, live


def _assert_store_equal(store, ref):
    for name in ("rows", "cols", "tail_rows", "tail_cols", "anti_rows", "anti_cols"):
        np.testing.assert_array_equal(_np(getattr(store, name)), _np(getattr(ref, name)), err_msg=name)
    for name in ("w", "tail_w"):
        np.testing.assert_allclose(_np(getattr(store, name)), _np(getattr(ref, name)), rtol=1e-6, atol=1e-6)
    assert (store.tail_count, store.anti_count, int(store.num_edges)) == (
        int(ref.tail_count), int(ref.anti_count), int(ref.num_edges))
    np.testing.assert_array_equal(_np(store.keys), _np(store.rows).astype(np.int64) * (N + 1) + _np(store.cols))


@pytest.mark.parametrize("weighted", [False, True])
def test_lazy_store_matches_jax_over_12_steps_and_compactions(rng, weighted):
    pairs, live = _replay(rng, weighted, 12)
    compactions = sum(b[0].fwd.tail_count < a[0].fwd.tail_count for a, b in zip(pairs, pairs[1:]))
    assert compactions >= 2
    for pair, jpair in pairs:
        _assert_store_equal(pair.fwd, jpair.fwd)
        _assert_store_equal(pair.bwd, jpair.bwd)
    # the live set, read back through a compaction, is the stream's
    for store, key in ((compact(pairs[-1][0].fwd), lambda r, c: c * N + r),
                       (compact(pairs[-1][0].bwd), lambda r, c: r * N + c)):
        r, c, w = _np(store.rows), _np(store.cols), _np(store.w)
        got = dict(zip(key(r[r < N].astype(np.int64), c[r < N].astype(np.int64)).tolist(), w[r < N].tolist()))
        assert got.keys() == live.keys()
        np.testing.assert_allclose([got[k] for k in sorted(live)], [live[k] for k in sorted(live)], rtol=1e-6)


def test_compact_matches_jax(rng):
    pairs, _ = _replay(rng, False, 3)
    pair, jpair = pairs[-1]
    _assert_store_equal(compact(pair.fwd), jax.jit(jax_compact)(jpair.fwd))


def _sentinel_store(rng, n=200, slots=1500, weighted=True):
    """A live-sorted flat store with sentinels spread through it, tombstones
    (w = 0), empty rows and a heavy row, padded for the Pallas kernel."""
    rows = np.sort(rng.integers(0, n - 20, slots))  # the last 20 rows empty
    rows[300:700] = rows[300]  # a heavy row
    rows = np.sort(rows)
    cols = rng.integers(0, n, slots)
    sentinel = rng.random(slots) < 0.1
    rows[sentinel], cols[sentinel] = n, n
    w = (rng.standard_normal(slots) if weighted else np.ones(slots)).astype(np.float32)
    w[sentinel] = 0.0
    w[rng.random(slots) < 0.1] = 0.0  # tombstones
    cap_pad = -(-slots // JAX_EDGE_CHUNK) * JAX_EDGE_CHUNK + JAX_EDGE_CHUNK
    pad = lambda a, v: np.concatenate([a, np.full(cap_pad - slots, v, a.dtype)])
    return pad(rows.astype(np.int32), n), pad(cols.astype(np.int32), n), pad(w, 0.0)


@pytest.mark.parametrize("weighted", [False, True])
def test_k6_plain_matches_pallas_interpret(rng, weighted):
    n, f = 200, 40
    rows, cols, w = _sentinel_store(rng, n, weighted=weighted)
    x = rng.standard_normal((n, f)).astype(np.float32)

    @jax.jit
    def jax_k6(rows, cols, w, x):
        return spmm_rowid_traced(rows, w, x[jnp.minimum(cols, n - 1)], n, interpret=True)[0]

    ref = jax_k6(rows, cols, w if weighted else None, x)
    if not weighted:  # unweighted: every real slot counts, tombstones included
        w = None
    out = RK.spmm_rowid(_t(rows), _t(cols), None if w is None else _t(w), _t(x), n)
    np.testing.assert_allclose(out.numpy(), _np(ref)[:n, :f], **F32)
    assert not out[n - 20:].any()
    blocked = RK.spmm_rowid_plain(_t(rows), _t(cols), None if w is None else _t(w), _t(x), n, edge_block=333)
    torch.testing.assert_close(blocked, out, rtol=0, atol=0)


@pytest.mark.parametrize("n, empty_block", [(200, None), (30, None), (400, 1)])
def test_k7_plain_matches_pallas_interpret(rng, n, empty_block):
    """Counts exact, weight sums to 1e-5; with ``empty_block``, a block of
    128 rows with no live slot between two that have some."""
    rows, _, w = _sentinel_store(rng, n)
    if empty_block is not None:
        lo, hi = empty_block * 128, (empty_block + 1) * 128
        rows[(rows >= lo) & (rows < hi)] = lo - 1
        rows[rows < n] = np.sort(rows[rows < n])
    w = np.abs(w)
    jax_k7 = jax.jit(lambda r, ww: JDS.dyn_degree(r, ww, n, interpret=True))
    count = RK.dyn_degree(_t(rows), None, n)
    np.testing.assert_array_equal(count.numpy(), _np(jax_k7(rows, None)))
    wsum = RK.dyn_degree(_t(rows), _t(w), n)
    ref = jax_k7(rows, w)
    np.testing.assert_allclose(wsum.numpy(), _np(ref), **F32)
    assert not count[n - 20:].any()
    if empty_block is not None:
        assert not count[lo:hi].any()


@pytest.mark.parametrize("weighted", [False, True])
def test_lazy_spmm_grad_and_norm_match_jax(rng, weighted):
    pairs, _ = _replay(rng, weighted, 6)  # after one compaction, logs in use
    pair, jpair = pairs[-1]
    assert pair.fwd.tail_count and (weighted or pair.fwd.anti_count)
    x = rng.standard_normal((N, 24)).astype(np.float32)
    r = rng.standard_normal((N, 24)).astype(np.float32)

    def jloss(xx):
        out = JDS.lazy_spmm(jpair, xx, interpret=True)
        return jnp.sum(out * r), out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out = DS.lazy_spmm(pair, xt)
    (out * _t(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), _np(jout), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), _np(jgrad), **F32)
    np.testing.assert_allclose(DS.lazy_norm(pair).numpy(), _np(jax.jit(JDS.lazy_norm)(jpair)), rtol=1e-6)


def test_backward_runs_k6_on_the_twin_store(rng, monkeypatch):
    pairs, _ = _replay(rng, False, 2)
    pair = pairs[-1][0]
    calls = []
    real = DS.spmm_rowid
    monkeypatch.setattr(DS, "spmm_rowid", lambda rows, *a: calls.append(rows) or real(rows, *a))
    x = torch.randn(N, 8, requires_grad=True)
    DS.lazy_spmm(pair, x).sum().backward()
    assert [c is s.rows for c, s in zip(calls, (pair.fwd, pair.bwd))] == [True, True]


def test_gcnconv_on_a_pair_matches_static_csr_and_refuses_edge_weight(rng):
    n = 200
    keys = rng.choice(n * n, 1600, replace=False)
    src, dst = keys // n, keys % n
    w = (0.1 + rng.random(len(keys))).astype(np.float32)
    pair = DS.lazy_pair_from_edges(src, dst, n, capacity=2048, tail_capacity=128, weights=w, device="cpu")
    g = StaticGraph(np.stack([src, dst], 1), None, n, device="cpu")
    conv = GCNConv(12, 8, device="cpu", generator=torch.Generator().manual_seed(0))
    x = _t(rng.standard_normal((n, 12)).astype(np.float32))
    xs, xp = x.clone().requires_grad_(), x.clone().requires_grad_()
    out_static = conv(g, xs, edge_weight=_t(w))
    out_pair = conv(pair, xp)
    torch.testing.assert_close(out_pair, out_static, rtol=2e-4, atol=2e-4)
    (out_static ** 2).sum().backward()
    (out_pair ** 2).sum().backward()
    torch.testing.assert_close(xp.grad, xs.grad, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="carry edge weights"):
        conv(pair, x, edge_weight=_t(w))


def _link_loss_torch(h, store, neg_s, neg_d):
    n = h.shape[0]
    rows = torch.cat([store.rows, store.tail_rows]).long().clamp(max=n - 1)
    cols = torch.cat([store.cols, store.tail_cols]).long().clamp(max=n - 1)
    mask = torch.cat([store.w, store.tail_w]) > 0
    pos = (h[cols] * h[rows]).sum(-1)
    neg = (h[neg_s] * h[neg_d]).sum(-1)
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    loss = bce(pos, torch.ones_like(pos), reduction="none") + bce(neg, torch.zeros_like(neg), reduction="none")
    return torch.where(mask, loss, 0.0).sum() / mask.sum().clamp(min=1)


def _link_loss_jax(h, store, neg_s, neg_d):
    import optax

    n = h.shape[0]
    rows = jnp.minimum(jnp.concatenate([store.rows, store.tail_rows]), n - 1)
    cols = jnp.minimum(jnp.concatenate([store.cols, store.tail_cols]), n - 1)
    mask = jnp.concatenate([store.w, store.tail_w]) > 0
    pos = jnp.sum(h[cols] * h[rows], -1)
    neg = jnp.sum(h[neg_s] * h[neg_d], -1)
    loss = (optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos))
            + optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)))
    return jnp.sum(jnp.where(mask, loss, 0.0)) / jnp.maximum(mask.sum(), 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_tgcn_link_prediction_on_a_pair_matches_jax(rng, weighted):
    """The lazy-scan script's body for three timesteps: the delta, TGCN on
    the pair, the link loss over the fwd store's main and tail slots with the
    same negatives in both packages; loss and every gradient."""
    lags, hidden, steps = 4, 8, 3
    src, dst, w, live = _initial(rng, weighted)
    jpair0 = JDS.lazy_pair_from_edges(src, dst, N, CAP, TCAP, weights=w)
    batches = _stream(rng, live, steps, weighted)
    xs = [rng.standard_normal((N, lags)).astype(np.float32) for _ in range(steps)]
    width = CAP + TCAP
    negs = [(rng.integers(0, N, width), rng.integers(0, N, width)) for _ in range(steps)]
    jmodel = JaxTGCN(lags, hidden)
    params = jax.jit(lambda k: jmodel.init(k, jpair0, jnp.asarray(xs[0])))(jax.random.key(1))

    @jax.jit
    def jloss(p):
        pair, h, losses = jpair0, jnp.zeros((N, hidden)), []
        for (a, dl, aw), x, (ns, nd) in zip(batches, xs, negs):
            a, dl = jnp.asarray(a), jnp.asarray(dl)
            pair = JDS.apply_delta_lazy_pair(pair, a[:, 0], a[:, 1], dl[:, 0], dl[:, 1],
                                             add_weights=None if aw is None else jnp.asarray(aw))
            h = jmodel.apply(p, pair, jnp.asarray(x), hidden=h)
            losses.append(_link_loss_jax(h, pair.fwd, ns, nd))
        return jnp.mean(jnp.stack(losses))

    jl, jgrads = jax.value_and_grad(jloss)(params)

    model = TGCN(lags, hidden, device="cpu")
    model.load_state_dict(tgcn_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    pair = lazy_pair_from_jax(jax.tree_util.tree_map(np.asarray, jpair0), device="cpu")
    h, losses = torch.zeros(N, hidden), []
    for (a, dl, aw), x, (ns, nd) in zip(batches, xs, negs):
        pair = DS.apply_delta_lazy_pair(pair, _t(a[:, 0]), _t(a[:, 1]), _t(dl[:, 0]), _t(dl[:, 1]),
                                        add_weights=None if aw is None else _t(aw))
        h = model(pair, _t(x), hidden=h)
        losses.append(_link_loss_torch(h, pair.fwd, _t(ns), _t(nd)))
    loss = torch.stack(losses).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    ref = tgcn_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **MODEL)


def test_synthetic_england_covid_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(JaxDataset, "_offline", True)
    monkeypatch.setattr(STGraphDataset, "_offline", True)
    port, ref = EnglandCovidDataLoader(), JaxEngland()
    assert port.synthetic and ref.synthetic and port.gdata == ref.gdata
    assert port.get_edges() == ref.get_edges()
    for a, b in zip(port.get_edge_weights(), ref.get_edge_weights()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.get_all_features() + port.get_all_targets(), ref.get_all_features() + ref.get_all_targets()):
        np.testing.assert_array_equal(a, b)
    assert len(port.get_all_features()) == 53
    assert (tmp_path / ".stgraph" / "dataset_cache_torch" / "England_COVID.json").exists()
