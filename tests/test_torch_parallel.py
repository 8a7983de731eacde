"""The port's distribution layer (``stgraph_tpu_torch.parallel``) against
the JAX package's (``stgraph_tpu.parallel``).

``partition_edges`` is held array for array at P = 1, 2 and 4; the
rectangular CSR that its shard CSRs need against numpy; ``launch`` on its
own. Then the port runs in P spawned gloo processes on the CPU
(``tests/scripts/torch_dist_worker.py``, one spawn for P = 2 and one for
P = 4, which starts when the P = 2 ranks are done) and every result is held against the JAX package on a P-device CPU
mesh (conftest's virtual devices), within 1e-4 as ``tests/test_parallel.py``
holds its own: ``dist_spmm`` on both routes (overlap on and off, one head
weighted, two heads weighted), ``dist_gat_attention``, the three layers with
parameters carried by ``convert``, and ``benchmarking/dist/train.py``'s
training step (loss, parameter gradients after the all-reduce, and the
parameters after one Adam step). The port's kernel route runs K1's shard
mode, whose plain version takes the CPU tensors.

The same spawns run the rest of the distribution layer: ``parallel.dyn``
(``partition_dynamic`` array for array at P = 1, 2 and 4 here; in the
ranks, each shard's store after every step of a replay, ``dist_dyn_spmm``,
its gradient and ``dist_dyn_degree``, unweighted and weighted, against
JAX's ``use_kernel=False`` path on the P-device mesh) and ``parallel.batch``
(the batched TGCN loss and its gradients on 1 x 2, 2 x 1 and 2 x 2 meshes
against JAX's ``dist_tgcn_cell`` run window by window, as
``tests/test_batch2d.py``'s sequential reference with the padding rows
masked, and its ``ValueError``s).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from stgraph_tpu.parallel import (
    dist_gat_attention as jax_dist_gat_attention,
    dist_spmm as jax_dist_spmm,
    partition_edges as jax_partition_edges,
    shard_edge_array as jax_shard_edge_array,
    shard_node_array as jax_shard_node_array,
)
from stgraph_tpu.graph.delta_graph import EdgeStore as JaxEdgeStore
from stgraph_tpu.parallel import dyn as jax_dyn
from stgraph_tpu.parallel import layers as jax_layers
from stgraph_tpu.parallel.layers import dist_gat_conv as jax_dist_gat_conv
from stgraph_tpu.parallel.layers import dist_gcn_conv as jax_dist_gcn_conv
from stgraph_tpu.parallel.layers import dist_tgcn_cell as jax_dist_tgcn_cell
from stgraph_tpu_torch import parallel
from stgraph_tpu_torch.graph.csr import CSR, csr_order
from stgraph_tpu_torch.graph.delta_graph import EdgeStore
from stgraph_tpu_torch.parallel import launch, make_mesh, partition_dynamic, partition_edges
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORKER = os.path.join(os.path.dirname(__file__), "scripts", "torch_dist_worker.py")
TOL = dict(rtol=1e-4, atol=1e-4)

N, E = 203, 1200  # uneven: 203 rows over 2 or 4 shards
SPMM_F, GAT_H, GAT_F = 16, 2, 64  # two heads of 64: the kernel route's tiling
GCN_DIMS, TRAIN_DIMS = (8, 16), (16, 32, 32, 5)
TGCN_IN, TGCN_OUT = 6, 5
DYN_F, DYN_T = 8, 3  # the dynamic graph's features and steps
BATCH_B, BATCH_T = 2, 2  # windows of TGCN_IN -> TGCN_OUT


# -- partition_edges ---------------------------------------------------------


@pytest.mark.parametrize("sort", ["native", "lexsort"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_partition_edges_matches_jax_array_for_array(p, sort, monkeypatch):
    """Both of ``csr_order``'s sorts: the native counting sort and, where it
    does not build, numpy's ``lexsort``."""
    from stgraph_tpu_torch import native

    if sort == "lexsort":
        monkeypatch.setattr(native, "build_csr_arrays", lambda *a, **k: None)
    rng = np.random.default_rng(p)
    n, e = 97, 700
    src = (n * rng.power(2.5, e)).astype(np.int64) % n  # hubs, as benchmarking/dist/train.py's graph
    dst = rng.integers(0, n, e)
    want = jax_partition_edges(src, dst, n, p)
    got = partition_edges(src, dst, n, p)
    for name in ("local_csr", "interior_csr", "frontier_csr"):
        w, g = getattr(want, name), getattr(got, name)
        for field in ("indptr", "rows", "cols", "eids", "num_edges"):
            np.testing.assert_array_equal(getattr(g, field), np.asarray(getattr(w, field)), err_msg=f"{name}.{field}")
        assert g.num_nodes == w.num_nodes
    for name in ("halo_offsets", "local_gids", "interior_gids", "frontier_gids", "interior_pos", "frontier_pos"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert len(got.send_idx_by_d) == len(want.send_idx_by_d) == p - 1
    for a, b in zip(got.send_idx_by_d, want.send_idx_by_d):
        np.testing.assert_array_equal(a, b)
    for name in ("num_nodes", "num_global_edges", "nodes_per_shard", "halo_total", "num_shards", "padded_nodes"):
        assert getattr(got, name) == getattr(want, name), name
    ns = got.nodes_per_shard
    assert (got.local_csr.num_cols, got.interior_csr.num_cols, got.frontier_csr.num_cols) == (
        ns + got.halo_total, ns, got.halo_total)


def test_shard_csrs_are_rectangular_and_reproduce_the_edges(rng):
    """A shard's CSRs on the device: rectangular, and together every edge of
    its destination range (the halo ids mapped back through the ring)."""
    n, e, p = 60, 400, 4
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    dg = partition_edges(src, dst, n, p)
    ns = dg.nodes_per_shard
    seen = []
    for r in range(p):
        sh = dg.shard(r, "cpu")
        assert sh is dg.shard(r, "cpu")
        loc, intr, fro = sh.local_csr, sh.interior_csr, sh.frontier_csr
        assert (loc.num_nodes, loc.num_cols) == (ns, ns + dg.halo_total)
        assert (intr.num_cols, fro.num_cols) == (ns, dg.halo_total)
        assert intr.num_edges + fro.num_edges == loc.num_edges
        # a halo slot names the global source it holds
        halo_src = np.zeros(dg.halo_total, np.int64)
        for d in range(1, p):
            q = (r - d) % p
            ids = dg.send_idx_by_d[d - 1][q]
            halo_src[dg.halo_offsets[d]: dg.halo_offsets[d] + len(ids)] = ids + q * ns
        rows, cols = loc.rows[: loc.num_edges].numpy(), loc.cols[: loc.num_edges].numpy()
        g_src = np.where(cols < ns, cols + r * ns, halo_src[np.maximum(cols - ns, 0)])
        seen += list(zip(g_src, rows + r * ns))
        assert (loc.rows[loc.num_edges:] == ns).all() and (loc.cols[loc.num_edges:] == 0).all()
    assert sorted(seen) == sorted(zip(src, dst))


def test_rectangular_csr_transpose_and_edge_perms_against_numpy(rng):
    """A 7 x 11 CSR padded as the shard CSRs are (cols 0, rows the sentinel):
    its transpose is 11 x 7 in (col, row) order, and ``edge_perms`` map the
    two edge orders onto each other."""
    n, m, e, cap = 7, 11, 40, 48
    dst, src = rng.integers(0, n, e), rng.integers(0, m, e)
    src[0] = m - 1  # a column past the last row
    order, indptr = csr_order(dst, src, n, m)
    np.testing.assert_array_equal(order, np.lexsort((src, dst)))
    rows = np.full(cap, n, np.int32)
    cols = np.zeros(cap, np.int32)
    eids = np.full(cap, cap, np.int32)
    rows[:e], cols[:e], eids[:e] = dst[order], src[order], order
    csr = CSR((indptr, rows, cols, eids), n, e, torch.device("cpu"), num_cols=m)
    t = csr.transpose()
    assert (t.num_nodes, t.num_cols, t.num_edges, t.capacity) == (m, n, e, cap)
    t_indptr, t_rows, t_cols, t_eids = t.host_arrays()
    want = np.lexsort((rows[:e], cols[:e]))
    np.testing.assert_array_equal(t_rows[:e], cols[:e][want])
    np.testing.assert_array_equal(t_cols[:e], rows[:e][want])
    np.testing.assert_array_equal(t_eids[:e], eids[:e][want])
    np.testing.assert_array_equal(t_indptr, np.concatenate([[0], np.cumsum(np.bincount(src, minlength=m))]))
    assert (t_rows[e:] == m).all() and (t_cols[e:] == n).all() and (t_eids[e:] == cap).all()
    np.testing.assert_array_equal(csr.col_degrees().numpy(), np.bincount(src, minlength=m))
    np.testing.assert_array_equal(csr.cols_clamped.numpy(), cols)  # clamped to num_cols - 1, not num_nodes - 1
    perm_t, perm_f, emask = (a.numpy() for a in csr.edge_perms())
    w = rng.standard_normal(cap).astype(np.float32)
    np.testing.assert_array_equal(w[perm_t][:e], w[:e][want])  # forward order -> transpose order
    np.testing.assert_array_equal(w[perm_t][perm_f][:e], w[:e])
    np.testing.assert_array_equal(emask, (np.arange(cap) < e).astype(np.float32))
    assert t.transpose().num_nodes == n


# -- launch ------------------------------------------------------------------


def test_launch_without_configuration_does_nothing(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    launch.initialize()
    assert not torch.distributed.is_initialized()
    assert launch.process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1,
                                     "global_devices": 1}
    assert not launch.is_multihost()
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")


@pytest.mark.parametrize("args, match", [
    (("127.0.0.1:1234", 2, 5), "outside a group"),
    (("127.0.0.1:1234", None, 0), "needs the coordinator"),
    (("127.0.0.1", 2, 0), "host:port"),
])
def test_launch_bad_explicit_configuration_raises(monkeypatch, args, match):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=match):
        launch.initialize(*args, backend="gloo")
    assert not torch.distributed.is_initialized()


def test_launch_world_of_one_from_the_environment(monkeypatch):
    """``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK`` make a group;
    ``shutdown`` ends it, so no group outlives the test."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    try:
        launch.initialize(backend="gloo")
        assert torch.distributed.get_backend() == "gloo"
        assert launch.process_info()["process_count"] == 1
        mesh = make_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("data", "graph")
        with pytest.raises(ValueError, match="needs 2 processes"):
            make_mesh(graph=2, device="cpu")
    finally:
        launch.shutdown()
    assert not torch.distributed.is_initialized()


def test_launch_after_the_group_was_destroyed_directly(monkeypatch):
    """A group ended by ``torch.distributed.destroy_process_group`` (not
    ``launch.shutdown``) leaves nothing behind: ``initialize`` makes a new one."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    try:
        launch.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
        torch.distributed.destroy_process_group()
        launch.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
        assert torch.distributed.is_initialized()
    finally:
        launch.shutdown()
    assert not torch.distributed.is_initialized()


# -- the layers' parameters --------------------------------------------------


@pytest.mark.parametrize("layer, args", [
    ("gcn", (48, 40)),
    ("gat", (32, 64, 16)),
    ("tgcn", (40, 32)),
])
def test_dist_params_match_jax_shapes_and_scales(layer, args):
    """The same keys, shapes and dtype as ``stgraph_tpu.parallel.layers``'
    ``dist_*_params``, zero biases, and the same uniform scale: each weight's
    largest magnitude within 3 % of JAX's (over 10^3 draws or more, both lie
    within 3 % of the bound)."""
    # one compiled program: drawn op by op, each random op compiles apart
    want = jax.jit(lambda key: getattr(jax_layers, f"dist_{layer}_params")(key, *args))(jax.random.PRNGKey(0))
    got = getattr(parallel, f"dist_{layer}_params")(torch.Generator().manual_seed(0), *args, device="cpu")
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        g, w = flat_got[path], np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32 and g.device.type == "cpu", path
        if path[-1].key == "bias":
            assert not g.any(), path
        else:
            top_got, top_want = g.abs().max().item(), np.abs(w).max()
            assert abs(top_got - top_want) <= 0.03 * top_want, (path, top_got, top_want)


# -- the port in P gloo processes against JAX on a P-device mesh ------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    src = (N * rng.power(2.5, E)).astype(np.int64) % N
    dst = rng.integers(0, N, E)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def uni(shape, scale):
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    inp = {
        "n": np.int64(N), "src": src, "dst": dst,
        "spmm_h": f32(N, SPMM_F), "spmm_g": f32(N, SPMM_F),
        "w1_h": f32(N, SPMM_F), "w1_w": f32(E), "w1_g": f32(N, SPMM_F),
        "wh_h": f32(N, GAT_H, GAT_F), "wh_w": f32(E, GAT_H), "wh_g": f32(N, GAT_H, GAT_F),
        "gat_el": f32(N, GAT_H), "gat_er": f32(N, GAT_H), "gat_fs": f32(N, GAT_H, GAT_F),
        "gat_g": f32(N, GAT_H, GAT_F),
        "norm": (rng.random((N, 1)) + 0.5).astype(np.float32),
        "gcn_x": f32(N, GCN_DIMS[0]), "gcn_g": f32(N, GCN_DIMS[1]),
        "tgcn_x": f32(N, TGCN_IN), "tgcn_hid": f32(N, TGCN_OUT), "tgcn_g": f32(N, TGCN_OUT),
        "gatc_x": f32(N, 8), "gatc_g": f32(N, GAT_H, GAT_F),
        "train_x": f32(N, TRAIN_DIMS[0]), "train_y": rng.integers(0, TRAIN_DIMS[-1], N).astype(np.int64),
        "train_layers": np.int64(len(TRAIN_DIMS) - 1),
    }
    a, b = GCN_DIMS
    inp["gcn_params/weight"], inp["gcn_params/bias"] = uni((a, b), (6 / (a + b)) ** 0.5), f32(b) * 0.1
    for gate in "zrh":
        inp[f"tgcn_params/conv_{gate}/weight"] = uni((TGCN_IN, TGCN_OUT), 0.6)
        inp[f"tgcn_params/conv_{gate}/bias"] = f32(TGCN_OUT) * 0.1
        inp[f"tgcn_params/lin_{gate}/weight"] = uni((2 * TGCN_OUT, TGCN_OUT), 0.6)
        inp[f"tgcn_params/lin_{gate}/bias"] = f32(TGCN_OUT) * 0.1
    inp["gatc_params/fc"] = uni((8, GAT_H * GAT_F), 0.3)
    inp["gatc_params/attn_l"], inp["gatc_params/attn_r"] = uni((GAT_H, GAT_F), 0.3), uni((GAT_H, GAT_F), 0.3)
    inp["gatc_params/bias"] = f32(GAT_H * GAT_F) * 0.1
    for i, (a, b) in enumerate(zip(TRAIN_DIMS[:-1], TRAIN_DIMS[1:])):
        inp[f"train_params/w{i}"] = (rng.standard_normal((a, b)) * 0.1).astype(np.float32)
        inp[f"train_params/b{i}"] = f32(b) * 0.1
    inp.update(_dyn_inputs(np.random.default_rng(seed + 1)))
    return inp


def _dyn_inputs(rng, e0=400, cap=512, adds=40, dels=20):
    """A dynamic graph on the N nodes: an initial (dst, src)-sorted store of
    ``e0`` edges with weights, DYN_T staged batches (each delete names a live
    edge, each add is new; the last slots sentinel padding) with weights, the
    features and each step's cotangent; and the windows of the batched loss."""
    keys = rng.choice(N * N, e0, replace=False)
    src, dst = keys // N, keys % N
    order = np.lexsort((src, dst))
    rows0, cols0, w0 = np.full(cap, N, np.int32), np.full(cap, N, np.int32), np.zeros(cap, np.float32)
    rows0[:e0], cols0[:e0] = dst[order], src[order]
    w0[:e0] = 0.5 + rng.random(e0)
    live = set(keys.tolist())
    add = np.full((DYN_T, adds + 4, 2), N, np.int32)
    dele = np.full((DYN_T, dels + 4, 2), N, np.int32)
    for t in range(DYN_T):
        gone = rng.choice(sorted(live), dels, replace=False)
        live -= set(gone.tolist())
        new = []
        while len(new) < adds:
            k = int(rng.integers(0, N * N))
            if k not in live and k not in new:
                new.append(k)
        live |= set(new)
        dele[t, :dels] = np.stack([gone // N, gone % N], 1)
        add[t, :adds] = np.stack([np.array(new) // N, np.array(new) % N], 1)
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return {"dyn_rows0": rows0, "dyn_cols0": cols0, "dyn_w0": w0, "dyn_ne0": np.int32(e0), "dyn_add": add,
            "dyn_del": dele, "dyn_add_w": (0.5 + rng.random(add.shape[:2])).astype(np.float32),
            "dyn_h": f32(N, DYN_F), "dyn_g": f32(DYN_T, N, DYN_F),
            "bt_x": f32(BATCH_B, BATCH_T, N, TGCN_IN), "bt_y": f32(BATCH_B, BATCH_T, N, TGCN_OUT)}


def _tree(inp, prefix):
    tree = {}
    for key, v in inp.items():
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1:].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = jnp.asarray(v)
    return tree


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


WORLDS = (2, 4)


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """``start(p)`` starts the ``p`` gloo ranks of a world, once, and
    returns (folder, processes). Every rank still running at the module's
    end is killed."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    worlds = {}

    def start(p):
        if p not in worlds:
            tmp = tmp_path_factory.mktemp(f"dist{p}")
            path = str(tmp / "inputs.npz")
            np.savez(path, **inputs)
            port = str(_free_port())
            worlds[p] = (tmp, [subprocess.Popen([sys.executable, WORKER, str(r), str(p), port, path, str(tmp)],
                                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
                               for r in range(p)])
        return worlds[p]

    try:
        yield start
    finally:
        for _, procs in worlds.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()


@pytest.fixture(scope="module", params=WORLDS, ids=["P2", "P4"])
def world(request, inputs, spawned):
    """The port's results from ``p`` spawned gloo ranks, and the JAX mesh.
    Once a world's ranks are done, the next world's start, so that they run
    while this world's cases are checked."""
    p = request.param
    tmp, procs = spawned(p)
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=240)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for q in WORLDS:
        if q > p:
            spawned(q)
            break
    for r, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"[rank {r}] TORCH DIST OK" in out, f"rank {r}:\n{out}"
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(p)]
    dg = jax_partition_edges(inputs["src"], inputs["dst"], N, p)
    mesh = Mesh(np.asarray(jax.devices()[:p]), ("graph",))
    return {"p": p, "ranks": ranks, "dg": dg, "mesh": mesh, "refs": {}}


def _nodes(world, key):
    """A node array of the port: the ranks' shards stacked (P·Ns rows)."""
    return np.concatenate([r[key] for r in world["ranks"]], axis=0)


def _edges(world, key):
    """Per-edge data of the port: (P, cap, ...)."""
    return np.stack([r[key] for r in world["ranks"]])


def _replicated(world, key):
    """A replicated value: equal on every rank."""
    vals = [r[key] for r in world["ranks"]]
    for v in vals[1:]:
        np.testing.assert_allclose(v, vals[0], rtol=1e-6, atol=1e-6)
    return vals[0]


def _ref(world, name, make):
    if name not in world["refs"]:
        world["refs"][name] = jax.tree_util.tree_map(np.asarray, make())
    return world["refs"][name]


def _sh(world, a):
    return jax_shard_node_array(world["mesh"], jnp.asarray(a), world["dg"])


def _vjp(fn, args, cot):
    """(fn(*args), cotangents of args) under jit."""

    @jax.jit
    def run(args, cot):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(cot)

    return run(args, cot)


def test_dist_spmm_unweighted_matches_jax(world, inputs):
    mesh, dg = world["mesh"], world["dg"]
    out, (dh,) = _ref(world, "spmm", lambda: _vjp(
        lambda hs: jax_dist_spmm(mesh, dg, hs), [_sh(world, inputs["spmm_h"])], _sh(world, inputs["spmm_g"])))
    for impl in ("torch", "kernel"):
        for overlap in (1, 0):
            key = f"spmm/{impl}/{overlap}"
            np.testing.assert_allclose(_nodes(world, key + "/out"), out, **TOL, err_msg=key)
            np.testing.assert_allclose(_nodes(world, key + "/dh"), dh, **TOL, err_msg=key)


@pytest.mark.parametrize("case", ["w1", "wh"])
def test_dist_spmm_weighted_matches_jax(world, inputs, case):
    """One head (cap,) and two heads (cap, 2) x 64: the plain route's widened
    reduction and the kernel route's both forms, values and the gradients of
    ``h`` and of the local-order weights."""
    mesh, dg = world["mesh"], world["dg"]

    def make():
        ws = jax_shard_edge_array(mesh, jnp.asarray(inputs[case + "_w"]), dg, "local")
        return _vjp(lambda hs, w: jax_dist_spmm(mesh, dg, hs, edge_weight=w),
                    [_sh(world, inputs[case + "_h"]), ws], _sh(world, inputs[case + "_g"]))

    out, (dh, dw) = _ref(world, case, make)
    for impl, overlap in (("torch", 1), ("kernel", 1), ("kernel", 0)):
        key = f"{case}/{impl}/{overlap}"
        np.testing.assert_allclose(_nodes(world, key + "/out"), out, **TOL, err_msg=key)
        np.testing.assert_allclose(_nodes(world, key + "/dh"), dh, **TOL, err_msg=key)
        np.testing.assert_allclose(_edges(world, key + "/dw").reshape(dw.shape), dw, **TOL, err_msg=key)


def test_dist_gat_attention_matches_jax(world, inputs):
    mesh, dg = world["mesh"], world["dg"]
    out, grads = _ref(world, "gat", lambda: _vjp(
        lambda a, b, c: jax_dist_gat_attention(mesh, dg, a, b, c),
        [_sh(world, inputs[k]) for k in ("gat_el", "gat_er", "gat_fs")], _sh(world, inputs["gat_g"])))
    for impl in ("torch", "kernel"):
        np.testing.assert_allclose(_nodes(world, f"gat/{impl}/out"), out, **TOL)
        for name, want in zip(("del", "der", "dfs"), grads):
            np.testing.assert_allclose(_nodes(world, f"gat/{impl}/{name}"), want, **TOL, err_msg=f"{impl} {name}")


def _check_layer(world, name, want_out, want_params, want_dx):
    for impl in ("torch", "kernel"):
        np.testing.assert_allclose(_nodes(world, f"{name}/{impl}/out"), want_out, **TOL)
        np.testing.assert_allclose(_nodes(world, f"{name}/{impl}/dx"), want_dx, **TOL)
        flat = jax.tree_util.tree_flatten_with_path(want_params)[0]
        assert flat
        for path, want in flat:
            key = f"{name}/{impl}/grad/" + "/".join(p.key for p in path)
            np.testing.assert_allclose(_replicated(world, key), want, **TOL, err_msg=key)


def test_dist_gcn_conv_matches_jax(world, inputs):
    mesh, dg = world["mesh"], world["dg"]
    norm = _sh(world, inputs["norm"])
    out, (gp, gx) = _ref(world, "gcn", lambda: _vjp(
        lambda p, x: jax_dist_gcn_conv(mesh, dg, p, x, norm, activation=jax.nn.relu),
        [_tree(inputs, "gcn_params"), _sh(world, inputs["gcn_x"])], _sh(world, inputs["gcn_g"])))
    _check_layer(world, "gcn", out, gp, gx)


def test_dist_tgcn_cell_matches_jax(world, inputs):
    mesh, dg = world["mesh"], world["dg"]
    norm, hid = _sh(world, inputs["norm"]), _sh(world, inputs["tgcn_hid"])
    out, (gp, gx) = _ref(world, "tgcn", lambda: _vjp(
        lambda p, x: jax_dist_tgcn_cell(mesh, dg, p, x, norm, hid),
        [_tree(inputs, "tgcn_params"), _sh(world, inputs["tgcn_x"])], _sh(world, inputs["tgcn_g"])))
    _check_layer(world, "tgcn", out, gp, gx)


def test_dist_gat_conv_matches_jax(world, inputs):
    mesh, dg = world["mesh"], world["dg"]
    out, (gp, gx) = _ref(world, "gatc", lambda: _vjp(
        lambda p, x: jax_dist_gat_conv(mesh, dg, p, x, activation=jax.nn.elu),
        [_tree(inputs, "gatc_params"), _sh(world, inputs["gatc_x"])], _sh(world, inputs["gatc_g"])))
    _check_layer(world, "gatc", out, gp, gx)


def test_dist_training_step_matches_jax(world, inputs):
    """``benchmarking/dist/train.py``'s ``build_step``: loss over the P·Ns
    padded rows, every parameter's gradient (the port's after
    ``reduce_replicated_grads``) and the parameters after one Adam(1e-2)
    step."""
    mesh, dg = world["mesh"], world["dg"]
    layers = int(inputs["train_layers"])

    def make():
        x, norm = _sh(world, inputs["train_x"]), _sh(world, inputs["norm"])
        y = np.zeros(dg.padded_nodes, np.int64)
        y[:N] = inputs["train_y"]
        params = {k[len("train_params/"):]: jnp.asarray(v) for k, v in inputs.items()
                  if k.startswith("train_params/")}

        def loss_fn(p):
            h = x
            for i in range(layers):
                h = (h @ p[f"w{i}"] + p[f"b{i}"]) * norm
                h = jax_dist_spmm(mesh, dg, h) * norm
                if i < layers - 1:
                    h = jax.nn.relu(h)
            return optax.softmax_cross_entropy_with_integer_labels(h, jnp.asarray(y)).mean()

        opt = optax.adam(1e-2)

        @jax.jit  # the loss, its gradients and the Adam step as one program
        def step(params):
            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, _ = opt.update(grads, opt.init(params))
            return loss, grads, optax.apply_updates(params, updates)

        return step(params)

    loss, grads, after = _ref(world, "train", make)
    for impl in ("torch", "kernel"):
        np.testing.assert_allclose(_replicated(world, f"train/{impl}/loss"), loss, **TOL)
        for k in grads:
            np.testing.assert_allclose(_replicated(world, f"train/{impl}/grad/{k}"), grads[k], **TOL, err_msg=k)
            np.testing.assert_allclose(_replicated(world, f"train/{impl}/after/{k}"), after[k], **TOL, err_msg=k)


def test_halo_rows_sent_match_the_ring(world):
    """Each rank sent, per exchange and per direction, the ring's sum of K_d
    rows: one exchange for each dist_spmm or GAT attention call, twice when
    it was differentiated."""
    dg = world["dg"]
    per = sum(s.shape[1] for s in dg.send_idx_by_d)
    assert per == dg.halo_total
    # 4 + 6 spmm calls, 2 GAT, 2 x (1 + 3 + 1) layers, 2 x 3 training: all differentiated
    calls = 4 + 6 + 2 + 2 * (1 + 3 + 1) + 2 * 3
    for r in world["ranks"]:
        assert int(r["exchange_rows"]) == 2 * calls * per


# -- parallel.dyn --------------------------------------------------------------


def _dyn_store(inputs, weighted, store_cls):
    return store_cls(rows=inputs["dyn_rows0"], cols=inputs["dyn_cols0"], num_edges=inputs["dyn_ne0"], num_nodes=N,
                     weights=inputs["dyn_w0"] if weighted else None)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_partition_dynamic_matches_jax_array_for_array(inputs, p, weighted):
    add_w = inputs["dyn_add_w"] if weighted else None
    want = jax_dyn.partition_dynamic(_dyn_store(inputs, weighted, JaxEdgeStore), inputs["dyn_add"],
                                     inputs["dyn_del"], add_w, p)
    got = partition_dynamic(_dyn_store(inputs, weighted, EdgeStore), torch.from_numpy(inputs["dyn_add"]),
                            inputs["dyn_del"], add_w, p)
    for name in want._fields:
        w, g = getattr(want, name), getattr(got, name)
        if w is None or isinstance(w, int):
            assert g == w, name
        else:
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.padded_nodes == want.padded_nodes
    with pytest.raises(ValueError, match="capacity too small"):
        partition_dynamic(_dyn_store(inputs, weighted, EdgeStore), inputs["dyn_add"], inputs["dyn_del"], add_w, p,
                          capacity=8)


def _jax_dyn_runs(world, inputs):
    """JAX's replay on the P-device mesh (``use_kernel=False``), unweighted
    (``u``) and weighted (``w``), both in one jitted call so that the two
    cases share a compile: the carry and the output and degrees after each
    step, and the features' gradient of the steps' summed products."""
    mesh = world["mesh"]
    ddgs, stores = [], []
    for weighted in (False, True):
        ddg = jax_dyn.partition_dynamic(_dyn_store(inputs, weighted, JaxEdgeStore), inputs["dyn_add"],
                                        inputs["dyn_del"], inputs["dyn_add_w"] if weighted else None, world["p"])
        ddgs.append(ddg)
        stores.append(jax_dyn.shard_dyn_arrays(mesh, ddg))
    h = _sh(world, inputs["dyn_h"])
    gs = [_sh(world, g) for g in inputs["dyn_g"]]

    def replay(ddg, h, carry, xs, gs):
        def loss(h):
            rows, cols, w, ne = carry
            total, trace = 0.0, []
            for t in range(DYN_T):
                rows, cols, w, ne = jax_dyn.dist_dyn_apply_delta(mesh, ddg, rows, cols, w, ne, xs[0][t], xs[1][t],
                                                                 None if xs[2] is None else xs[2][t])
                out = jax_dyn.dist_dyn_spmm(mesh, ddg, rows, cols, w, h, use_kernel=False)
                deg = jax_dyn.dist_dyn_degree(mesh, ddg, rows, use_kernel=False)
                total = total + jnp.sum(out * gs[t])
                trace.append((rows, cols, w, ne, out, deg))
            return total, trace

        (_, trace), dh = jax.value_and_grad(loss, has_aux=True)(h)
        return trace, dh

    @jax.jit
    def run(h, stores, gs):
        return tuple(replay(ddg, h, carry, xs, gs) for ddg, (carry, xs) in zip(ddgs, stores))

    return dict(zip(("u", "w"), jax.tree_util.tree_map(np.asarray, run(h, stores, gs))))


@pytest.mark.parametrize("case", ["u", "w"])
def test_dist_dyn_replay_spmm_and_degree_match_jax(world, inputs, case):
    """Each rank's store after every step (rows, cols, weights, live count)
    against JAX's shard of the stacked carry; each step's ``dist_dyn_spmm``
    and ``dist_dyn_degree`` (the port's K6 and K7 plain versions over the
    all-gathered table) and the features' gradient."""
    trace, dh = _ref(world, "dyn", lambda: _jax_dyn_runs(world, inputs))[case]
    for t, (rows, cols, w, ne, out, deg) in enumerate(trace):
        key = f"dyn/{case}/{t}"
        np.testing.assert_array_equal(_edges(world, key + "/rows"), rows, err_msg=key)
        np.testing.assert_array_equal(_edges(world, key + "/cols"), cols, err_msg=key)
        np.testing.assert_array_equal(_edges(world, key + "/ne"), ne, err_msg=key)
        if case == "w":
            np.testing.assert_array_equal(_edges(world, key + "/w"), w, err_msg=key)
        np.testing.assert_allclose(_nodes(world, key + "/out"), out, **TOL, err_msg=key)
        np.testing.assert_array_equal(_nodes(world, key + "/deg"), deg, err_msg=key)
    np.testing.assert_allclose(_nodes(world, f"dyn/{case}/dh"), dh, **TOL)


# -- parallel.batch ------------------------------------------------------------


def _jax_batch_reference(inputs):
    """JAX's ``dist_tgcn_cell`` window by window on a 2-device graph mesh
    (``tests/test_batch2d.py``'s sequential reference, each timestep's
    squared error over the real rows only, over N * F_out): the mean loss
    over the windows and its parameter gradients."""
    dg = jax_partition_edges(inputs["src"], inputs["dst"], N, 2)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("graph",))

    def sh(a):
        return jax_shard_node_array(mesh, jnp.asarray(a), dg)

    norm = sh(inputs["norm"])
    xs = [[sh(inputs["bt_x"][b, t]) for t in range(BATCH_T)] for b in range(BATCH_B)]
    ys = [[sh(inputs["bt_y"][b, t]) for t in range(BATCH_T)] for b in range(BATCH_B)]
    mask = (jnp.arange(dg.padded_nodes) < N)[:, None]

    def loss(params):
        total = 0.0
        for b in range(BATCH_B):
            hidden, steps = jnp.zeros((dg.padded_nodes, TGCN_OUT)), []
            for t in range(BATCH_T):
                hidden = jax_dist_tgcn_cell(mesh, dg, params, xs[b][t], norm, hidden)
                steps.append(jnp.sum(jnp.where(mask, (hidden - ys[b][t]) ** 2, 0.0)) / (N * TGCN_OUT))
            total = total + jnp.stack(steps).mean()
        return total / BATCH_B

    return jax.tree_util.tree_map(np.asarray, jax.jit(jax.value_and_grad(loss))(_tree(inputs, "tgcn_params")))


@pytest.fixture(scope="module")
def batch_reference(inputs):
    return _jax_batch_reference(inputs)


def test_batched_tgcn_loss_and_grads_match_sequential_jax(world, batch_reference):
    """On every 2-D mesh of the world's ranks (1 x 2 and 2 x 1 at P = 2,
    2 x 2 at P = 4): the loss on every rank and every rank's parameter
    gradients after ``backward()`` alone; and the batch of 3 windows over 2
    data ranks refused by ``shard_window_batch`` and by the loss."""
    loss, grads = batch_reference
    meshes = {2: ("1x2", "2x1"), 4: ("2x2",)}[world["p"]]
    for mesh in meshes:
        np.testing.assert_allclose(_replicated(world, f"batch/{mesh}/loss"), loss, **TOL, err_msg=mesh)
        flat = jax.tree_util.tree_flatten_with_path(grads)[0]
        for path, want in flat:
            key = f"batch/{mesh}/grad/" + "/".join(p.key for p in path)
            np.testing.assert_allclose(_replicated(world, key), want, **TOL, err_msg=key)
        if mesh.startswith("2x"):
            assert all(int(r[f"batch/{mesh}/refused"]) == 2 for r in world["ranks"])
