"""The PMA store slice against the JAX package on the same numpy inputs:
``pma_from_edges`` and a replay array for array after every step (both the
chunk-local merge and the rebuild branch, weighted and unweighted), the
pair's ``pma_spmm`` (and its input gradient) and ``pma_norm``, ``GCNConv``
and ``TGCN`` over a pair with parameters carried by ``convert``, and
``drivers.dynamic_temporal_tgcn --type pma-scan`` against the body of
``benchmarking/dynamic-temporal-tgcn/train.py``'s ``pma-scan`` with the same
negatives.

The JAX side runs under ``jax.jit`` on its jnp path (off the TPU its
``pma_spmm`` and ``pma_norm`` take no Pallas kernel; K6's and K7's plain
versions are held against the kernels in interpret mode by
``tests/test_torch_dynamic.py``).

Tolerances: store layouts, counts and edge totals are exact (both packages
sort, bisect and rank the same keys); weights are copied, never summed, so
they are exact too. The SpMM and its gradient sum in f32 in another order:
1e-5. TGCN and the driver: losses to 1e-5 relative, gradients to 1e-4
relative and 1e-5 absolute, as ``tests/test_torch_temporal.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgraph_tpu.dataset import EnglandCovidDataLoader as JaxEngland
from stgraph_tpu.dataset.base import STGraphDataset as JaxDataset
from stgraph_tpu.graph import DeltaGraph as JaxDeltaGraph
from stgraph_tpu.graph import pma_store as JP
from stgraph_tpu.nn import GCNConv as JaxGCNConv
from stgraph_tpu.nn import TGCN as JaxTGCN
from stgraph_tpu.ops import dyn_spmm as JDS
from stgraph_tpu_torch.convert import gcn_params_from_jax, pma_pair_from_jax, tgcn_params_from_jax
from stgraph_tpu_torch.dataset import EnglandCovidDataLoader, STGraphDataset
from stgraph_tpu_torch.drivers import dynamic_temporal_tgcn as DT
from stgraph_tpu_torch.graph import pma_store as P
from stgraph_tpu_torch.nn import TGCN, GCNConv
from stgraph_tpu_torch.ops import dyn_spmm as DS
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32 = dict(rtol=1e-5, atol=1e-5)
LOSS = dict(rtol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _assert_store_equal(store, ref, msg=""):
    for name in ("rows", "cols", "counts"):
        np.testing.assert_array_equal(_np(getattr(store, name)), _np(getattr(ref, name)), err_msg=f"{msg} {name}")
    assert int(store.num_edges) == int(ref.num_edges), msg
    assert (store.weights is None) == (ref.weights is None), msg
    if store.weights is not None:
        np.testing.assert_array_equal(_np(store.weights), _np(ref.weights), err_msg=f"{msg} weights")


def _batch(keys, n, width, weights=None):
    """(width, 2) int32 (src, dst) rows of the keys ``src * n + dst``,
    sentinel-padded; and their (width,) weights."""
    out = np.full((width, 2), n, np.int32)
    w = np.zeros(width, np.float32)
    for i, k in enumerate(keys):
        out[i] = divmod(k, n)
        if weights is not None:
            w[i] = weights[i]
    return out, w


# -- the store -------------------------------------------------------------

N, C, S = 60, 16, 8


def _steps(rng, live, weighted):
    """Twelve delta batches keeping the store's contract. Step 4 adds ten
    edges into one empty row (they route to one chunk: more deltas than a
    chunk's workspace of S), step 8 adds seven into another (the chunk's
    live count passes S while its deltas fit), the other steps delete and
    add three edges (weighted: one a weight update) in batches of their own
    width, so that no sentinel padding reaches a chunk's workspace."""
    out = []
    for step in range(12):
        order = sorted(live)
        used_rows = {k % N for k in live}
        if step in (4, 8):
            row = min(r for r in range(N) if r not in used_rows)
            adds = [src * N + row for src in range(10 if step == 4 else 7)]
            dels, updates = [], []
        else:
            dels = [order[i] for i in rng.permutation(len(order))[:3]]
            updates = [k for k in order if k not in dels][:1] if weighted else []
            adds = list(updates)
            while len(adds) < 3:
                k = int(rng.integers(0, N * N))
                if k not in live and k not in adds and k not in dels:
                    adds.append(k)
        aw = (0.5 + rng.random(len(adds))).astype(np.float32)
        for k in dels:
            live.pop(k)
        for k, w in zip(adds, aw):
            live[k] = float(w) if weighted else 1.0
        a, a_w = _batch(adds, N, len(adds), aw)
        d, _ = _batch(dels + updates, N, max(len(dels) + len(updates), 1))
        out.append((a, d, a_w if weighted else None))
    return out


@jax.jit
def _jax_store_steps(stores, batches):
    # the store is keyed (dst, src)
    return tuple(JP.apply_delta_pma(st, a[:, 1], a[:, 0], d[:, 1], d[:, 0], add_weights=aw)
                 for st, (a, d, aw) in zip(stores, batches))


@functools.lru_cache(maxsize=None)
def _replays():
    """Each case's edges, steps and final live set (``np.random.default_rng(0)``
    as the ``rng`` fixture), and JAX's store after building and after each
    step. The unweighted and weighted replays step together, one jitted
    call a step for both stores, so the two cases share each step's
    compile."""
    cases = {}
    for weighted in (False, True):
        rng = np.random.default_rng(0)
        keys = rng.choice(N * N, 30, replace=False)
        w = (0.5 + rng.random(30)).astype(np.float32) if weighted else None
        live = {int(k): (1.0 if w is None else float(w[i])) for i, k in enumerate(keys)}
        steps = _steps(rng, live, weighted)
        cases[weighted] = (keys, w, steps, live, [JP.pma_from_edges(keys // N, keys % N, N, C, S, weights=w)])
    for t in range(12):
        out = _jax_store_steps(tuple(cases[wt][4][-1] for wt in (False, True)),
                               tuple(cases[wt][2][t] for wt in (False, True)))
        for wt, jstore in zip((False, True), out):
            cases[wt][4].append(jstore)
    return cases


@pytest.mark.parametrize("weighted", [False, True])
def test_pma_store_replay_matches_jax_in_both_branches(weighted):
    keys, w, steps, live, jstores = _replays()[weighted]
    store = P.pma_from_edges(keys // N, keys % N, N, C, S, weights=w, device="cpu")
    _assert_store_equal(store, jstores[0], "built")
    rebuilt = []
    for t, ((a, d, aw), jstore) in enumerate(zip(steps, jstores[1:])):
        before = P.apply_delta_pma.rebuilds
        nxt = P.apply_delta_pma(store, _t(a[:, 1]), _t(a[:, 0]), _t(d[:, 1]), _t(d[:, 0]),
                                add_weights=None if aw is None else _t(aw))
        rebuilt.append(P.apply_delta_pma.rebuilds - before)
        _assert_store_equal(nxt, jstore, f"step {t}")
        assert nxt is not store and nxt.rows.data_ptr() != store.rows.data_ptr()  # out of place
        store = nxt
    assert rebuilt[4] == rebuilt[8] == 1, rebuilt  # too hot, then an overflowing chunk
    assert rebuilt.count(0) >= 6, rebuilt  # the chunk-local merge
    r, c, wt = store.flatten()
    got = {int(ci) * N + int(ri): (1.0 if wt is None else float(wt[i])) for i, (ri, ci) in enumerate(zip(r, c))
           if ri < N}
    assert got == live


# -- the pair's SpMM and norm, GCNConv and TGCN -----------------------------

PN, PC, PS = 90, 6, 128


def _pair_stream(rng, weighted, steps):
    """An initial edge list and ``steps`` batches of 4 deletes and 6 adds."""
    keys = rng.choice(PN * PN, 300, replace=False)
    w = (0.5 + rng.random(300)).astype(np.float32) if weighted else None
    live = {int(k): 1.0 for k in keys}
    batches = []
    for _ in range(steps):
        order = sorted(live)
        dels = [order[i] for i in rng.permutation(len(order))[:4]]
        for k in dels:
            live.pop(k)
        adds = []
        while len(adds) < 6:
            k = int(rng.integers(0, PN * PN))
            if k not in live and k not in adds:
                adds.append(k)
        for k in adds:
            live[k] = 1.0
        aw = (0.5 + rng.random(6)).astype(np.float32)
        a, a_w = _batch(adds, PN, 8, aw)
        d, _ = _batch(dels, PN, 8)
        batches.append((a, d, a_w if weighted else None))
    return keys // PN, keys % PN, w, batches


@jax.jit
def _jax_pair_steps(pairs, batches):
    return tuple(JDS.apply_delta_pair(pr, a[:, 0], a[:, 1], d[:, 0], d[:, 1], add_weights=aw)
                 for pr, (a, d, aw) in zip(pairs, batches))


@functools.lru_cache(maxsize=None)
def _jax_pairs():
    """Each case's stream (from ``np.random.default_rng(0)``, the ``rng``
    fixture's) with the generator's state after it, and JAX's pair after
    each of its three steps. The unweighted and weighted streams step
    together, one jitted call a step for both pairs, so the two cases share
    each step's compile."""
    cases = {}
    for weighted in (False, True):
        rng = np.random.default_rng(0)
        src, dst, w, batches = _pair_stream(rng, weighted, 3)
        cases[weighted] = (src, dst, w, batches, rng.bit_generator.state,
                           [JDS.pma_pair_from_edges(src, dst, PN, PC, PS, weights=w)])
    for t in range(3):
        out = _jax_pair_steps(tuple(cases[wt][5][-1] for wt in (False, True)),
                              tuple(cases[wt][3][t] for wt in (False, True)))
        for wt, jpair in zip((False, True), out):
            cases[wt][5].append(jpair)
    return cases


def _pairs(rng, weighted):
    """The JAX pair and the port's after each of three steps, from one
    initial state; ``rng`` (the ``rng`` fixture) is left as drawing the
    stream left it."""
    src, dst, w, batches, state, jpairs = _jax_pairs()[weighted]
    rng.bit_generator.state = state
    pair = DS.pma_pair_from_edges(src, dst, PN, PC, PS, weights=w, device="cpu")
    for side in ("fwd", "bwd"):
        _assert_store_equal(getattr(pair, side), getattr(pma_pair_from_jax(
            jax.tree_util.tree_map(np.asarray, jpairs[0]), device="cpu"), side), side)
    out = []
    for (a, d, aw), jpair in zip(batches, jpairs[1:]):
        pair = DS.apply_delta_pair(pair, _t(a[:, 0]), _t(a[:, 1]), _t(d[:, 0]), _t(d[:, 1]),
                                   add_weights=None if aw is None else _t(aw))
        _assert_store_equal(pair.fwd, jpair.fwd, "fwd")
        _assert_store_equal(pair.bwd, jpair.bwd, "bwd")
        out.append((pair, jpair))
    return src, dst, w, batches, out


@pytest.mark.parametrize("weighted", [False, True])
def test_pma_spmm_grad_and_norm_match_jax(rng, weighted):
    _, _, _, _, pairs = _pairs(rng, weighted)
    pair, jpair = pairs[-1]
    x = rng.standard_normal((PN, 24)).astype(np.float32)
    r = rng.standard_normal((PN, 24)).astype(np.float32)

    def jloss(xx):
        out = JDS.pma_spmm(jpair, xx)
        return jnp.sum(out * r), (out, JDS.pma_norm(jpair))

    (_, (jout, jnorm)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = _t(x).requires_grad_()
    out = DS.pma_spmm(pair, xt)
    (out * _t(r)).sum().backward()
    np.testing.assert_allclose(_np(out), _np(jout), **F32)
    np.testing.assert_allclose(_np(xt.grad), _np(jgrad), **F32)
    np.testing.assert_allclose(_np(DS.pma_norm(pair)), _np(jnorm), rtol=1e-6)


def test_pma_backward_runs_k6_on_the_twin_store(rng, monkeypatch):
    _, _, _, _, pairs = _pairs(rng, False)
    pair = pairs[0][0]
    calls = []
    real = DS.spmm_rowid
    monkeypatch.setattr(DS, "spmm_rowid", lambda rows, *a: calls.append(rows) or real(rows, *a))
    x = torch.randn(PN, 8, requires_grad=True)
    DS.pma_spmm(pair, x).sum().backward()
    assert [c.data_ptr() == s.rows.data_ptr() for c, s in zip(calls, (pair.fwd, pair.bwd))] == [True, True]


def _link_loss_torch(h, store, neg_s, neg_d):
    rows, cols, _ = store.flatten()
    return DT.link_loss(h, rows.clamp(max=PN - 1), cols.clamp(max=PN - 1), rows < PN, neg_s, neg_d)


def _link_loss_jax(h, store, neg_s, neg_d):
    rows, cols, _ = store.flatten()
    pos = jnp.sum(h[jnp.minimum(cols, PN - 1)] * h[jnp.minimum(rows, PN - 1)], -1)
    neg = jnp.sum(h[neg_s] * h[neg_d], -1)
    loss = (optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos))
            + optax.sigmoid_binary_cross_entropy(neg, jnp.zeros_like(neg)))
    return jnp.sum(jnp.where(rows < PN, loss, 0.0)) / jnp.maximum((rows < PN).sum(), 1)


@pytest.mark.parametrize("weighted", [False, True])
def test_gcnconv_and_tgcn_over_a_pma_pair_match_jax(rng, weighted):
    """``GCNConv`` on the last pair (output and input gradient), and TGCN
    over each of three steps' pairs (``_pairs``: JAX's and the port's, equal
    array for array) with the link loss over the fwd store's flat view and
    the same negatives; loss and every gradient. The pma-scan body with its
    deltas inside is ``test_pma_scan_epochs_match_jax``'s. ``GCNConv``
    refuses ``edge_weight`` with a pair."""
    lags, hidden = 4, 8
    _, _, _, batches, pairs = _pairs(rng, weighted)
    xs = [rng.standard_normal((PN, lags)).astype(np.float32) for _ in batches]
    slots = PC * PS
    negs = [(rng.integers(0, PN, slots), rng.integers(0, PN, slots)) for _ in batches]

    jconv = JaxGCNConv(lags, hidden)
    pair, jpair = pairs[-1]
    cparams = jax.jit(lambda k: jconv.init(k, jpair, jnp.asarray(xs[0])))(jax.random.key(2))
    cot = rng.standard_normal((PN, hidden)).astype(np.float32)

    @jax.jit
    def jconv_vjp(x, c):
        out, vjp = jax.vjp(lambda xx: jconv.apply(cparams, jpair, xx), x)
        return out, vjp(c)[0]

    jout, jdx = jconv_vjp(jnp.asarray(xs[0]), jnp.asarray(cot))
    conv = GCNConv(lags, hidden, device="cpu")
    conv.load_state_dict(gcn_params_from_jax(jax.tree_util.tree_map(np.asarray, cparams)))
    x0 = _t(xs[0]).requires_grad_()
    out = conv(pair, x0)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(_np(out), _np(jout), **F32)
    np.testing.assert_allclose(_np(x0.grad), _np(jdx), **F32)
    with pytest.raises(ValueError, match="carry edge weights"):
        conv(pair, x0, edge_weight=torch.ones(slots))

    jmodel = JaxTGCN(lags, hidden)
    params = jax.jit(lambda k: jmodel.init(k, jpair, jnp.asarray(xs[0])))(jax.random.key(1))

    def jloss(p):  # train.py's scan body after each step's delta
        h, losses = jnp.zeros((PN, hidden)), []
        for (_, jp), x, (ns, nd) in zip(pairs, xs, negs):
            h = jmodel.apply(p, jp, jnp.asarray(x), hidden=h)
            losses.append(_link_loss_jax(h, jp.fwd, jnp.asarray(ns), jnp.asarray(nd)))
        return jnp.stack(losses).mean()

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    model = TGCN(lags, hidden, device="cpu")
    model.load_state_dict(tgcn_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    h, losses = torch.zeros(PN, hidden), []
    for (pair_t, _), x, (ns, nd) in zip(pairs, xs, negs):
        h = model(pair_t, _t(x), hidden=h)
        losses.append(_link_loss_torch(h, pair_t.fwd, _t(ns), _t(nd)))
    loss = torch.stack(losses).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **LOSS)
    ref = tgcn_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(ref[k]), err_msg=k, **GRAD)


# -- the driver's pma-scan against train.py's ---------------------------------

DYN = dict(cutoff=12, lags=4, hidden=8, epochs=2, lr=1e-2)


@pytest.fixture
def offline(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(JaxDataset, "_offline", True)
    monkeypatch.setattr(JaxDataset, "_save_dataset", lambda self: None)
    monkeypatch.setattr(STGraphDataset, "_offline", True)


def _jax_pma_scan(d, negs, lags, hidden, epochs, lr):
    """``train.py``'s ``pma-scan``: the pair built from the live slots of
    ``snapshot_store(lags - 1)`` (S = 256, C = max(ceil(cap / S) * 2, 2)),
    its epoch step's body with the negatives given; the initial parameters,
    and each epoch's loss and gradients (an Adam step between epochs)."""
    g = JaxDeltaGraph(d.get_edges(), d.get_edge_weights())
    n = g.get_num_nodes()
    feats = jnp.asarray(np.stack(d.get_all_features()), jnp.float32)
    t_total = feats.shape[0]
    sa, sd = (x[lags:lags + t_total] for x in g.staged_deltas())
    sw = g.staged_add_weights()[lags:lags + t_total]
    s0 = g.snapshot_store(lags - 1)
    rows0, cols0, w0 = np.asarray(s0.rows), np.asarray(s0.cols), np.asarray(s0.weights)
    live = rows0 < n
    s = 256
    pair0 = JDS.pma_pair_from_edges(cols0[live], rows0[live], n, num_chunks=max((g._capacity + s - 1) // s * 2, 2),
                                    chunk_size=s, weights=w0[live])
    model, opt = JaxTGCN(lags, hidden), optax.adam(lr)
    params = jax.jit(lambda k, x: model.init(k, pair0, x))(jax.random.key(0), feats[0])

    def loss_fn(p, neg):
        def body(carry, xs):
            hidden_, pair = carry
            add, dele, add_w, x_t, (ns, nd) = xs
            pair = JDS.apply_delta_pair(pair, add[:, 0], add[:, 1], dele[:, 0], dele[:, 1], add_weights=add_w)
            hidden_ = model.apply(p, pair, x_t, hidden=hidden_)
            rows_f, cols_f, _ = pair.fwd.flatten()
            pos = jnp.sum(hidden_[jnp.minimum(cols_f, n - 1)] * hidden_[jnp.minimum(rows_f, n - 1)], -1)
            neg_ = jnp.sum(hidden_[ns] * hidden_[nd], -1)
            mask = rows_f < n
            loss = jnp.sum(jnp.where(mask, optax.sigmoid_binary_cross_entropy(pos, jnp.ones_like(pos))
                                     + optax.sigmoid_binary_cross_entropy(neg_, jnp.zeros_like(neg_)), 0.0))
            return (hidden_, pair), loss / jnp.maximum(mask.sum(), 1)

        return jax.lax.scan(body, (jnp.zeros((n, hidden)), pair0), (sa, sd, sw, feats, neg))[1].mean()

    @jax.jit
    def epoch_step(p, state, neg):
        loss, grads = jax.value_and_grad(loss_fn)(p, neg)
        updates, state = opt.update(grads, state)
        return optax.apply_updates(p, updates), state, loss, grads

    p, state, out = params, opt.init(params), []
    for e in range(epochs):
        p, state, loss, grads = epoch_step(p, state, tuple(jnp.asarray(x) for x in negs[e]))
        out.append((float(loss), tgcn_params_from_jax(jax.tree_util.tree_map(np.asarray, grads))))
    return tgcn_params_from_jax(jax.tree_util.tree_map(np.asarray, params)), out, pair0.fwd.capacity


def test_pma_scan_epochs_match_jax(offline):
    """Two Adam epochs on England-COVID (8 timesteps from snapshot 4), one
    negative pair a slot of the PMA layout (the layouts are equal array for
    array, so a slot's negative is the same in both): each epoch's loss and
    parameter gradients."""
    c = DYN
    jd = JaxEngland(lags=c["lags"], cutoff_time=c["cutoff"])
    d = EnglandCovidDataLoader(lags=c["lags"], cutoff_time=c["cutoff"])
    tr = DT.DynamicTemporalTrainer(d.get_edges(), d.get_edge_weights(), d.get_all_features(), "pma-scan", c["lags"],
                                   c["hidden"], c["lr"], device="cpu")
    n, steps = tr.num_nodes, len(d.get_all_features())
    slots = tr.pair0.fwd.capacity
    rng = np.random.default_rng(0)
    negs = [tuple(rng.integers(0, n, (steps, slots)).astype(np.int32) for _ in range(2)) for _ in range(c["epochs"])]
    init, ref, jax_slots = _jax_pma_scan(jd, negs, c["lags"], c["hidden"], c["epochs"], c["lr"])
    assert jax_slots == slots and tr.steps == steps == c["cutoff"] - c["lags"]
    epoch = [0]

    def negatives(t, k):
        assert k == slots
        return tuple(torch.from_numpy(x[t]) for x in negs[epoch[0]])

    tr.negatives = negatives
    tr.model.load_state_dict(init)
    for e, (ref_loss, ref_grads) in enumerate(ref):
        epoch[0] = e
        tr.opt.zero_grad(set_to_none=True)
        loss = tr.epoch_loss()
        loss.backward()
        np.testing.assert_allclose(loss.item(), ref_loss, err_msg=f"epoch {e}", **LOSS)
        for k, p in tr.model.named_parameters():
            np.testing.assert_allclose(_np(p.grad), _np(ref_grads[k]), err_msg=f"epoch {e} {k}", **GRAD)
        tr.opt.step()
