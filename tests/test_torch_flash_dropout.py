"""Attention dropout on GAT's flash route against the JAX package on the same
numpy inputs: ``edge_keep_mask`` bit for bit, K8's and K9's dropout mode
(their plain versions, through the port's ``autograd.Function``) against
``flash_gat_attention(interpret=True, attn_drop, drop_seed)`` and
``jax.grad``, K9's dropout mode against autograd of the edge-domain route
given the same hash mask, ``GATConv``'s three attention-dropout routes, a
two-layer GAT with one Adam step against a JAX composition of
``sparse_gat_attention(interpret=True, attn_drop_rate, attn_drop_seed)``
with the port's drawn seeds, and the kernel libraries' build hash.

Tolerances, as ``tests/test_torch_gat.py``: the mask is exact (bit-equal).
K8 in f32 does the JAX kernel's arithmetic with sums in another order:
2e-4. With a bf16 stream the JAX kernel reads ``el`` as a bf16 hi/lo pair
(about 17 bits) where the port reads f32, so a weight can round to the
neighbouring bf16 value: 2e-2. Gradients: 2e-3 (the JAX package's own
flash-gradient tolerance). Layers and models in f32: 1e-4 relative and
1e-5 absolute, the flash and edge-domain routes summing in other orders.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.ops import attention as JA
from stgraph_tpu.ops import spmm_pallas
from stgraph_tpu.ops.flash_gat import edge_keep_mask as jax_edge_keep_mask
from stgraph_tpu.ops.flash_gat import flash_gat_attention as jax_flash
from stgraph_tpu_torch.convert import gat_params_from_jax
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import GATConv
from stgraph_tpu_torch.nn.gat_conv import attention_dropout_seed
from stgraph_tpu_torch.ops import attention as A
from stgraph_tpu_torch.ops import flash_gat as FG
from stgraph_tpu_torch.ops import kernel_lib, spmm_cuda
from stgraph_tpu_torch.utils import build as B

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
GRAD = dict(rtol=2e-3, atol=2e-3)
MODEL = dict(rtol=1e-4, atol=1e-5)

DROP_TILINGS = [(4, 32), (1, 47)]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _edges(rng, n=150, e=1500):
    """A heavy duplicate edge and isolated destinations (the last three)."""
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    src[: e // 10] = src[0]
    dst[: e // 10] = dst[0]
    dst = np.where(dst >= n - 3, 0, dst)
    return src, dst


def _scores(rng, n, h, f, scale=1.0):
    el = (rng.standard_normal((n, h)) * scale).astype(np.float32)
    er = (rng.standard_normal((n, h)) * scale).astype(np.float32)
    fs = rng.standard_normal((n, h * f)).astype(np.float32)
    return el, er, fs


@pytest.fixture
def forced_bf16_stream(monkeypatch):
    """Every graph streams bf16, in both packages."""
    monkeypatch.setattr(spmm_pallas, "_BF16_STREAM_MIN_EDGES", 0)
    monkeypatch.setattr(spmm_cuda, "_BF16_STREAM_MIN_EDGES", 0)


# -- edge_keep_mask ----------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.1, 0.35, 0.6])
@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1, 2_654_435_761])
def test_edge_keep_mask_matches_jax_bit_for_bit(rng, seed, rate):
    e = 20_000
    src = rng.integers(0, 2**31 - 1, e)  # ids up to 2^31 - 2
    dst = rng.integers(0, 2**31 - 1, e)
    src[:2], dst[:2] = 2**31 - 2, 0
    for heads in (1, 8, 21):
        ref = np.asarray(jax_edge_keep_mask(src, dst, np.uint32(seed), heads, rate))
        out = FG.edge_keep_mask(_t(src).int(), _t(dst).int(), seed, heads, rate)
        assert out.dtype == torch.float32 and out.shape == (e, heads)
        np.testing.assert_array_equal(out.numpy().view(np.uint32), ref.view(np.uint32))
    # a one-element tensor seed of any integer type hashes as the int
    as_tensor = FG.edge_keep_mask(_t(src).int(), _t(dst).int(), torch.tensor([seed]), 8, rate)
    assert torch.equal(as_tensor, FG.edge_keep_mask(_t(src).int(), _t(dst).int(), seed, 8, rate))


def test_edge_keep_mask_pinned_values():
    """The first bits of JAX's mask, written out: a typo in a constant or a
    shift fails here even where both packages were edited alike."""
    src = torch.tensor([0, 1, 2, 123456789, 2**31 - 2, 5], dtype=torch.int32)
    dst = torch.tensor([0, 7, 2**31 - 2, 42, 3, 5], dtype=torch.int32)
    pinned = {
        0: ["1101", "0000", "1100", "1101", "0010", "1001"],
        2**32 - 1: ["1111", "1110", "0110", "1100", "1001", "1110"],
        7: ["1111", "1111", "1011", "0010", "1010", "1100"],
    }
    for seed, rows in pinned.items():
        q = FG.edge_keep_mask(src, dst, seed, 4, 0.5)
        assert ["".join("1" if v > 0 else "0" for v in r) for r in q.tolist()] == rows, seed
        assert set(q.unique().tolist()) == {0.0, 2.0}
    assert FG.edge_keep_mask(src, dst, 0, 1, 0.3).max().item() == np.float32(1 / 0.7)


def test_edge_keep_mask_unbiased_and_order_free(rng):
    """Counterpart of ``tests/test_flash_gat.py``'s: keep probability
    1 - p per (edge, head), mean 1, and the same value for a pair whatever
    its position (what the transpose-order backward relies on)."""
    e, h, rate = 40_000, 8, 0.35
    src = _t(rng.integers(0, 10_000, e)).int()
    dst = _t(rng.integers(0, 10_000, e)).int()
    q = FG.edge_keep_mask(src, dst, 7, h, rate)
    assert abs((q > 0).float().mean().item() - (1 - rate)) < 0.01
    assert abs(q.mean().item() - 1.0) < 0.02
    perm = _t(rng.permutation(e))
    assert torch.equal(FG.edge_keep_mask(src[perm], dst[perm], 7, h, rate), q[perm])
    # the CPU wrapper of the in-kernel hash is the plain function
    assert torch.equal(FG.edge_keep_mask_kernel(src, dst, 7, h, rate), q)


# -- K8 and K9 in dropout mode -----------------------------------------------------


def _csrs(rng, n=150, e=1500):
    src, dst = _edges(rng, n, e)
    return build_csr(src, dst, n, device="cpu"), jax_build_csr(src, dst, n), n


@pytest.mark.parametrize("h,f", DROP_TILINGS)
def test_flash_dropout_matches_jax_flash_f32(rng, h, f):
    csr, jcsr, n = _csrs(rng)
    el, er, fs = _scores(rng, n, h, f)
    # No cotangent on the three rows without in-edges: there gu = g / tiny
    # is ~1e38 g, which JAX's kernel gathers into its padding slots, and the
    # keep factor 1 / (1 - p) overflows it, so inf * 0 turns columns of its
    # dfs into NaN (a fault of the reference, ROADMAP.md; K9 reads gu only at
    # real edges, and the K9 test below holds a full cotangent against
    # autograd).
    g = rng.standard_normal((n, h * f)).astype(np.float32)
    g[n - 3:] = 0.0
    rate, seed = 0.6, 3_000_000_019

    def jloss(a, b, c):
        out = jax_flash(jcsr, a, b, c, heads=h, interpret=True, attn_drop=rate, drop_seed=np.uint32(seed))
        return jnp.sum(out * g), out

    (_, ref), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(el, er, fs)
    tel, ter, tfs = (_t(v).requires_grad_() for v in (el, er, fs))
    out = FG.flash_gat_attention(csr, tel, ter, tfs, h, attn_drop=rate, drop_seed=torch.tensor([seed]))
    np.testing.assert_allclose(out.detach().numpy(), _np(ref), **F32)
    np.testing.assert_array_equal(out.detach().numpy()[n - 3:], 0.0)
    (out * _t(g)).sum().backward()
    for name, t, r in zip(("dl", "der", "dfs"), (tel, ter, tfs), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), err_msg=name, **GRAD)
    # the mask took effect: without it the output differs
    assert not torch.allclose(out.detach(), FG.flash_gat_attention(csr, _t(el), _t(er), _t(fs), h), **F32)


@pytest.mark.parametrize("h,f", DROP_TILINGS)
def test_flash_dropout_matches_jax_flash_bf16_stream(rng, forced_bf16_stream, h, f):
    """Both packages decide the stream from the graph, through their
    ``sparse_gat_attention``; the fixture makes every graph stream bf16."""
    csr, jcsr, n = _csrs(rng)
    el, er, fs = _scores(rng, n, h, f, scale=3.0)
    fs3 = fs.reshape(n, h, f)
    rate, seed = 0.35, 12345
    ref = jax.jit(lambda a, b, c: JA.sparse_gat_attention(
        jcsr, a[..., None], b[..., None], c, interpret=True, attn_drop_rate=rate, attn_drop_seed=np.uint32(seed)
    ))(el, er, fs3)
    out = A.sparse_gat_attention(csr, _t(el)[..., None], _t(er)[..., None], _t(fs3), attn_drop_rate=rate,
                                 attn_drop_seed=seed)
    np.testing.assert_allclose(out.numpy(), _np(ref), **BF16)
    f32 = FG.flash_gat_attention(csr, _t(el), _t(er), _t(fs), h, attn_drop=rate, drop_seed=seed)
    assert not torch.equal(out.reshape(n, -1), f32)  # the port rounds where its plain version says


def test_k8_dropout_keeps_the_undropped_denominator(rng):
    """den and p sum the undropped weights; out and u take the mask."""
    csr, _, n = _csrs(rng)
    h, f, slope = 4, 8, 0.2
    el, er, fs = (_t(v) for v in _scores(rng, n, h, f))
    m = FG.stability_max(csr, el, er, slope)
    base = FG.flash_gat_fwd(csr, el, er, m, fs, h, slope, aux=True)
    drop = FG.flash_gat_fwd(csr, el, er, m, fs, h, slope, aux=True, rate=0.5, seed=9)
    assert torch.equal(drop[1], base[1]) and torch.equal(drop[3], base[3])
    assert not torch.allclose(drop[0], base[0]) and not torch.allclose(drop[2], base[2])
    with pytest.raises(ValueError, match="needs a seed"):
        FG.flash_gat_fwd(csr, el, er, m, fs, h, slope, rate=0.5)
    with pytest.raises(ValueError, match="rate"):
        FG.flash_gat_bwd(csr.transpose(), el, er, m, el, fs, fs, h, slope, rate=1.0, seed=0)
    with pytest.raises(ValueError, match="flash path"):
        A.sparse_gat_attention(csr, el[..., None], er[..., None], torch.zeros(n, 2, 300), attn_drop_rate=0.5)


def test_k9_dropout_matches_the_autograd_of_the_edge_route(rng):
    """K9's dropout mode (its plain version, inside ``_FlashGat``) gives the
    gradients of the edge-domain route with the same hash mask, the
    forward CSR's (cols, rows) hashed once, differentiated by autograd."""
    csr, _, n = _csrs(rng)
    h, f, slope, rate, seed = 2, 8, 0.2, 0.4, 77
    el, er, fs = _scores(rng, n, h, f)
    g = _t(rng.standard_normal((n, h * f)).astype(np.float32))
    leaves = [tuple(_t(v).requires_grad_() for v in (el, er, fs)) for _ in range(2)]
    out = FG.flash_gat_attention(csr, *leaves[0], h, slope, attn_drop=rate, drop_seed=seed)
    (out * g).sum().backward()
    keep = FG.edge_keep_mask(csr.cols, csr.rows, seed, h, rate)
    a, b, c = leaves[1]
    ref = A.composed_gat_attention_dropout(csr, a[..., None], b[..., None], c.reshape(n, h, f), slope, rate,
                                           keep=keep)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().reshape(n, -1).numpy(), **F32)
    (ref.reshape(n, -1) * g).sum().backward()
    for name, t, r in zip(("dl", "der", "dfs"), leaves[0], leaves[1]):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), err_msg=name, **GRAD)


# -- GATConv's routes and a model ---------------------------------------------------


@pytest.mark.parametrize("h,f,route", [(8, 32, "a"), (1, 47, "a"), (4, 128, "b"), (8, 8, "c"), (32, 4, "c")])
def test_gatconv_attention_dropout_routes(rng, monkeypatch, h, f, route):
    """Routed by the tiling alone: (a) the flash kernels' dropout mode,
    (b) the edge-domain route with the same hash mask, (c) the edge-domain
    route with ``torch.rand``. Each output against the route it should
    take, from the seed (or the noise) a twin generator draws."""
    src, dst = _edges(rng, 300, 3000)
    g = StaticGraph(np.stack([src, dst], 1), None, 300, device="cpu")
    x = _t(rng.standard_normal((300, 12)).astype(np.float32))
    seen = []
    fwd = FG.flash_gat_fwd
    monkeypatch.setattr(FG, "flash_gat_fwd", lambda *a, **k: seen.append(("k8", k["rate"])) or fwd(*a, **k))
    edge = A.composed_gat_attention_dropout
    monkeypatch.setattr(A, "composed_gat_attention_dropout",
                        lambda *a, **k: seen.append(("edge", k.get("keep") is not None)) or edge(*a, **k))
    conv = GATConv(12, f, h, attn_drop=0.6, impl="sparse", device="cpu",
                   generator=torch.Generator().manual_seed(1)).train()
    out = conv(g, x, generator=torch.Generator().manual_seed(2))
    out.sum().backward()
    assert out.shape == (300, h, f) and all(torch.isfinite(p.grad).all() for p in conv.parameters())
    assert seen == {"a": [("k8", 0.6)], "b": [("edge", True)], "c": [("edge", False)]}[route]
    csr = g.fwd_csr
    twin = torch.Generator().manual_seed(2)
    with torch.no_grad():
        fsrc = conv.fc(x).reshape(-1, h, f)
        el = (fsrc * conv.attn_l).sum(-1, keepdim=True)
        er = (fsrc * conv.attn_r).sum(-1, keepdim=True)
        if route == "c":
            ref = edge(csr, el, er, fsrc, 0.2, 0.6, twin)
        else:
            keep = FG.edge_keep_mask(csr.cols, csr.rows, attention_dropout_seed(twin, "cpu"), h, 0.6)
            ref = edge(csr, el, er, fsrc, 0.2, 0.6, keep=keep)
    if route == "a":  # the flash route against the edge route: sums in other orders
        np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), **MODEL)
    else:
        assert torch.equal(out.detach(), ref)
    # evaluation mode draws nothing and drops nothing
    seen.clear()
    gen = torch.Generator().manual_seed(3)
    conv.eval()(g, x, generator=gen)
    assert gen.get_state().equal(torch.Generator().manual_seed(3).get_state())
    assert all(s == ("k8", 0.0) for s in seen)


def _jax_gat_logits(params, jcsr, x, seeds, heads, rate):
    """JAX ``GATConv``'s flash-dropout branch (``gat_conv.py:131-144``),
    layer by layer: ELU and concatenated heads, then the mean of the output
    heads."""
    h = x
    tree = params["params"]
    for i, (nh, seed) in enumerate(zip(heads, seeds)):
        p = tree[f"GATConv_{i}"]
        fs = (h @ p["fc"]["kernel"]).reshape(h.shape[0], nh, -1)
        el = jnp.sum(fs * p["attn_l"][None], -1, keepdims=True)
        er = jnp.sum(fs * p["attn_r"][None], -1, keepdims=True)
        h = JA.sparse_gat_attention(jcsr, el, er, fs, negative_slope=0.2, interpret=True, attn_drop_rate=rate,
                                    attn_drop_seed=seed)
        h = jax.nn.elu(h).reshape(h.shape[0], -1) if i < len(heads) - 1 else h.mean(axis=1)
    return h


def test_two_layer_dropout_gat_and_adam_step_match_jax(rng):
    """4 x 32 (ELU) -> 1 x 7 with ``attn_drop`` 0.6 on both layers, one Adam
    step: the port's layers on route (a) against JAX's
    ``sparse_gat_attention(interpret=True)`` fed the seeds the port drew."""
    src, dst = _edges(rng)
    n, fin, classes, rate, heads = 150, 20, 7, 0.6, (4, 1)
    widths = [(fin, 32, 4), (128, classes, 1)]
    tree = {"params": {f"GATConv_{i}": {
        "fc": {"kernel": (rng.standard_normal((a, hh * f)) * np.sqrt(4.0 / (a + hh * f))).astype(np.float32)},
        "attn_l": (rng.standard_normal((hh, f)) * np.sqrt(4.0 / (hh + f))).astype(np.float32),
        "attn_r": (rng.standard_normal((hh, f)) * np.sqrt(4.0 / (hh + f))).astype(np.float32),
    } for i, (a, f, hh) in enumerate(widths)}}
    x = rng.standard_normal((n, fin)).astype(np.float32)
    y = rng.integers(0, classes, n)
    g = StaticGraph(np.stack([src, dst], 1), None, n, device="cpu")
    layers = torch.nn.ModuleList(
        GATConv(a, f, hh, attn_drop=rate, impl="sparse", device="cpu",
                activation=torch.nn.functional.elu if i == 0 else None) for i, (a, f, hh) in enumerate(widths))
    model = torch.nn.Module()
    model.layers = layers
    model.load_state_dict(gat_params_from_jax(tree))
    model.train()
    twin = torch.Generator().manual_seed(5)
    seeds = [int(attention_dropout_seed(twin, "cpu")) for _ in heads]
    gen = torch.Generator().manual_seed(5)
    h = layers[0](g, _t(x), generator=gen).reshape(n, -1)
    logits = layers[1](g, h, generator=gen).mean(1)
    loss = torch.nn.functional.cross_entropy(logits, _t(y))
    topt = torch.optim.Adam(model.parameters(), lr=5e-3)
    loss.backward()

    jcsr = jax_build_csr(src, dst, n)
    opt = optax.adam(5e-3)

    def loss_fn(p):
        out = _jax_gat_logits(p, jcsr, jnp.asarray(x), [np.uint32(s) for s in seeds], heads, rate)
        return optax.softmax_cross_entropy_with_integer_labels(out, jnp.asarray(y)).mean(), out

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    updates, _ = opt.update(jgrads, opt.init(params))
    new_params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits), **MODEL)
    np.testing.assert_allclose(loss.item(), float(jloss), **MODEL)
    ref = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[k].numpy(), err_msg=k, **GRAD)
    topt.step()
    # Adam's first step moves each parameter by about lr sign(g): held to
    # MODEL where |g| >= 1e-6 (tests/test_torch_composed_gat.py)
    final = gat_params_from_jax(jax.tree_util.tree_map(np.asarray, new_params))
    for k, v in model.state_dict().items():
        firm = np.abs(ref[k].numpy()) >= 1e-6
        np.testing.assert_allclose(v.numpy()[firm], final[k].numpy()[firm], err_msg=k, **MODEL)
        assert np.abs(v.numpy() - final[k].numpy()).max() <= 2 * 5e-3, k


# -- the kernels' build hash ---------------------------------------------------------


def test_kernel_library_name_hashes_local_headers(tmp_path, monkeypatch):
    """An edited header included by ``#include "..."`` (followed through
    headers it includes) gives the kernel library a new name, so a stale
    build is never loaded. No nvcc: names only."""
    monkeypatch.setattr(B, "_PKG_DIR", str(tmp_path / "pkg"))  # build/ under tmp_path
    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cstdint>\n#include "inc/a.cuh"\n__global__ void k() {}\n')
    (tmp_path / "inc" / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("#define B 1\n")
    monkeypatch.setattr(kernel_lib, "_CSRC", str(tmp_path))
    monkeypatch.setitem(kernel_lib.SOURCES, "probe", "k.cu")
    assert kernel_lib.local_headers(str(src)) == [str(tmp_path / "inc" / "a.cuh"), str(tmp_path / "inc" / "b.cuh")]
    names = [os.path.basename(kernel_lib._paths(["probe"])["probe"])]
    (tmp_path / "inc" / "b.cuh").write_text("#define B 2\n")
    names.append(os.path.basename(kernel_lib._paths(["probe"])["probe"]))
    (tmp_path / "inc" / "b.cuh").write_text("#define B 1\n")
    names.append(os.path.basename(kernel_lib._paths(["probe"])["probe"]))
    assert names[0].startswith("libprobe-") and names[0] != names[1] and names[0] == names[2]
    assert (tmp_path / "build" / "kernels").is_dir()
    # a library built from a shared source with its own defines has its own name
    monkeypatch.setitem(kernel_lib.SOURCES, "probe_mode", "k.cu")
    monkeypatch.setitem(kernel_lib.DEFINES, "probe_mode", ["-DMODE=1"])
    paths = kernel_lib._paths(["probe", "probe_mode"])
    assert os.path.basename(paths["probe_mode"]).split("-")[1] != os.path.basename(paths["probe"]).split("-")[1]
    # the shipped kernels: K8 and K9 carry the hash's header in their names,
    # and each has a dropout-mode library built from its source
    csrc = os.path.join(os.path.dirname(FG.__file__), os.pardir, "csrc")
    for name in ("flash_gat_fwd", "flash_gat_bwd"):
        assert [os.path.basename(p) for p in kernel_lib.local_headers(os.path.join(csrc, f"{name}.cu"))] == [
            "edge_keep_mask.cuh"]
        assert kernel_lib.SOURCES[f"{name}_dropout"] == kernel_lib.SOURCES[name]
        assert kernel_lib.DEFINES[f"{name}_dropout"] == ["-DSTG_DROPOUT_MODE=1"]
