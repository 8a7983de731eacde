"""K1's shard mode (``spmm_rowmask_traced``) against the JAX package's
traced kernel, and the distribution layer at one rank.

The port's plain version of ``spmm_rowmask_traced`` (the CPU tensors take
it) is held against ``segment_pallas.spmm_rowmask_traced(interpret=True)``
fed JAX's own pre-gathered rows and block metadata of the same partition,
as ``parallel/halo.py`` feeds it: unweighted on a frontier CSR whose halo
table is taller than the shard, weighted on an interior CSR, and two heads
of 64 with the denominator on a local ``[local | halo]`` CSR. Then the
world-size-1 configuration that the card runs at ogbn-products size (one
rank, an empty frontier) against JAX on one device, in-process, with a gloo
group made and destroyed inside the test.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from stgraph_tpu.ops.segment_pallas import spmm_rowmask_traced as jax_traced
from stgraph_tpu.parallel import dist_spmm as jax_dist_spmm
from stgraph_tpu.parallel import partition_edges as jax_partition_edges
from stgraph_tpu.parallel import shard_node_array as jax_shard_node_array
from stgraph_tpu_torch.ops import spmm_kernels
from stgraph_tpu_torch.parallel import dist_spmm, launch, make_mesh, partition_edges, shard_node_array
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

P, N, E = 4, 97, 900


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(11)
    src = (N * rng.power(2.5, E)).astype(np.int64) % N
    dst = rng.integers(0, N, E)
    return jax_partition_edges(src, dst, N, P), partition_edges(src, dst, N, P)


def _jax_reduce(dg, which, shard, w, table, heads, with_denom=False):
    """``halo.py``'s Pallas reduction for one shard: JAX's own pre-gathered
    (cap_pad, H·F) rows and the shard's block metadata."""
    csr = getattr(dg, f"{which}_csr")
    rm = getattr(dg, f"{which}_rowmask")
    cap_pad = getattr(dg, f"{which}_cap_pad")
    cols = np.asarray(csr.cols[shard])
    cap = cols.shape[0]
    cols = np.pad(cols, (0, cap_pad - cap))
    gathered = jnp.asarray(table)[np.minimum(cols, table.shape[0] - 1)]
    w_pad = None if w is None else jnp.asarray(np.pad(w.reshape(cap, heads), ((0, cap_pad - cap), (0, 0))))
    meta = [jnp.asarray(rm[k][shard]) for k in ("astart", "nchunks", "bs", "be")]
    ns = dg.nodes_per_shard
    out, den = jax.jit(lambda m, w_, g: jax_traced(*m, w_, g, heads=heads, with_denom=with_denom,
                                                     interpret=True))(meta, w_pad, gathered)
    out = np.asarray(out)[:ns, : table.shape[1]]
    return (out, np.asarray(den)[:ns, :heads]) if with_denom else out


def _slot_weights(csr, heads, rng):
    """Weights in a shard CSR's slot order, 0 on its padding slots."""
    w = rng.standard_normal((csr.capacity, heads)).astype(np.float32)
    w[csr.num_edges:] = 0.0
    return w


def test_k1_traced_frontier_unweighted_matches_jax(graphs):
    dg_j, dg = graphs
    assert dg.halo_total > dg.nodes_per_shard  # the halo table is taller than the shard
    rng = np.random.default_rng(0)
    shard = 1
    csr = dg.shard(shard, "cpu").frontier_csr
    assert csr.num_edges > 0
    table = rng.standard_normal((dg.halo_total, 16)).astype(np.float32)
    got, den = spmm_kernels.spmm_rowmask_traced(csr, None, torch.from_numpy(table))
    assert den is None and got.shape == (dg.nodes_per_shard, 16)
    np.testing.assert_allclose(got.numpy(), _jax_reduce(dg_j, "frontier", shard, None, table, 1), rtol=1e-5,
                               atol=1e-5)


def test_k1_traced_interior_weighted_matches_jax(graphs):
    dg_j, dg = graphs
    rng = np.random.default_rng(1)
    shard = 2
    csr = dg.shard(shard, "cpu").interior_csr
    assert csr.num_edges > 0
    table = rng.standard_normal((dg.nodes_per_shard, 10)).astype(np.float32)
    w = _slot_weights(csr, 1, rng)
    got, _ = spmm_kernels.spmm_rowmask_traced(csr, torch.from_numpy(w).reshape(-1), torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), _jax_reduce(dg_j, "interior", shard, w, table, 1), rtol=1e-5,
                               atol=1e-5)


def test_k1_traced_two_heads_with_denom_matches_jax(graphs):
    """Two heads of 64 over the widened [local | halo] table, with the
    denominator, as ``dist_gat_attention``'s kernel route runs it."""
    dg_j, dg = graphs
    rng = np.random.default_rng(2)
    shard = 0
    csr = dg.shard(shard, "cpu").local_csr
    table = rng.standard_normal((dg.nodes_per_shard + dg.halo_total, 128)).astype(np.float32)
    w = np.abs(_slot_weights(csr, 2, rng))
    got, den = spmm_kernels.spmm_rowmask_traced(csr, torch.from_numpy(w), torch.from_numpy(table), heads=2,
                                                with_denom=True)
    want, want_den = _jax_reduce(dg_j, "local", shard, w, table, 2, with_denom=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(den.numpy(), want_den, rtol=1e-5, atol=1e-5)


def test_k1_traced_contract(graphs):
    """The rectangular contract: the table has ``num_cols`` rows, the output
    ``num_nodes``; a CSR without edges gives zeros; the stream is the
    table's dtype (bf16 rounds the gathered values); the JAX tiling rule."""
    _, dg = graphs
    sh = dg.shard(3, "cpu")
    ns, halo = dg.nodes_per_shard, dg.halo_total
    with pytest.raises(ValueError, match="num_cols"):
        spmm_kernels.spmm_rowmask_traced(sh.frontier_csr, None, torch.zeros(ns, 4))
    with pytest.raises(ValueError, match="128 % F"):
        spmm_kernels.spmm_rowmask_traced(sh.local_csr, torch.zeros(sh.local_csr.capacity, 2),
                                         torch.zeros(ns + halo, 2 * 48), heads=2)
    one = partition_edges(np.arange(5), np.arange(5), 5, 1).shard(0, "cpu")
    assert one.frontier_csr.num_edges == 0
    out, _ = spmm_kernels.spmm_rowmask_traced(one.frontier_csr, None, torch.ones(8, 3))
    assert out.shape == (5, 3) and not out.any()
    table = torch.randn(ns, 8)
    f32, _ = spmm_kernels.spmm_rowmask_traced(sh.interior_csr, None, table)
    bf, _ = spmm_kernels.spmm_rowmask_traced(sh.interior_csr, None, table.to(torch.bfloat16))
    np.testing.assert_allclose(f32.numpy(), spmm_kernels.spmm_rowmask_plain(sh.interior_csr, None, table).numpy(),
                               rtol=0, atol=0)
    np.testing.assert_allclose(bf.numpy(), spmm_kernels.spmm_rowmask_plain(
        sh.interior_csr, None, table, torch.bfloat16).numpy(), rtol=0, atol=0)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_world_of_one_matches_jax_on_one_device(impl):
    """The card's ogbn configuration at test size: one rank (P = 1: no
    ring, an empty frontier that launches nothing), values and gradients
    against JAX's ``dist_spmm`` on a one-device mesh."""
    rng = np.random.default_rng(3)
    n, e, f = 150, 1000, 12
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    h, g = rng.standard_normal((n, f)).astype(np.float32), rng.standard_normal((n, f)).astype(np.float32)
    dg_j = jax_partition_edges(src, dst, n, 1)
    mesh_j = Mesh(np.asarray(jax.devices()[:1]), ("graph",))
    hs, gs = (jax_shard_node_array(mesh_j, jnp.asarray(a), dg_j) for a in (h, g))
    out, vjp = jax.vjp(jax.jit(lambda x: jax_dist_spmm(mesh_j, dg_j, x)), hs)
    (dh,) = vjp(gs)
    launch.initialize(f"127.0.0.1:{_free_port()}", 1, 0, backend="gloo")
    try:
        mesh = make_mesh(device="cpu")
        dg = partition_edges(src, dst, n, 1)
        assert dg.shard(0, "cpu").frontier_csr.num_edges == 0
        x = shard_node_array(mesh, torch.from_numpy(h), dg).requires_grad_(True)
        y = dist_spmm(mesh, dg, x, impl=impl)
        (y * shard_node_array(mesh, torch.from_numpy(g), dg)).sum().backward()
    finally:
        launch.shutdown()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(dh), rtol=1e-4, atol=1e-4)
