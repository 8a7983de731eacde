"""``ops.segment_sum_edges`` against the JAX package's
``spmm_pallas.segment_sum_edges(interpret=True)`` under ``jax.jit``, on the
same numpy inputs: trailing shapes ``()``, ``(4,)``, ``(3, 2)``, ``(16,)``
(K3's widest) and ``(24,)`` (K1's no-gather mode), f32 and bf16 values,
finite garbage in the padding slots (JAX multiplies them by a 0 mask, so
NaN there would poison its sums; the port never reads them).

Tolerances: the forward to 1e-4, as ``tests/test_pallas.py`` holds JAX's
against its oracle, and the gradient of ``sum(out^2)`` to 1e-4. Both return
f32 sums for bf16 values; JAX's custom VJP also returns an f32 gradient,
where torch's autograd gives a gradient the input's dtype, so a bf16
input's gradient is held to JAX's to one bf16 rounding (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.ops import spmm_pallas as SP
from stgraph_tpu_torch import ops
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.ops import kernel_lib
from stgraph_tpu_torch.ops import segment_kernels as SK
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

N, E, CAP = 300, 2000, 2048  # tests/test_pallas.py's graph, with 48 padding slots
TOL = dict(rtol=1e-4, atol=1e-4)
BF16_GRAD = dict(rtol=2**-8, atol=1e-4)
SHAPES = [(), (4,), (3, 2), (16,), (24,)]


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, N, E), rng.integers(0, N, E)
    return jax_build_csr(src, dst, N, capacity=CAP), build_csr(src, dst, N, capacity=CAP, device="cpu")


def _values(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((CAP,) + shape).astype(np.float32)
    v[E:] = 1e3 * rng.standard_normal((CAP - E,) + shape)  # finite garbage in the padding slots
    return v.astype(jnp.bfloat16) if dtype == "bf16" else v


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_segment_sum_edges_matches_jax(graphs, shape, dtype):
    jcsr, csr = graphs
    v = _values(shape, dtype, 0)
    jv = jnp.asarray(v)
    ref = jax.jit(lambda v: SP.segment_sum_edges(jcsr, v, interpret=True))(jv)
    ref_grad = jax.jit(jax.grad(lambda v: (SP.segment_sum_edges(jcsr, v, interpret=True) ** 2).sum()))(jv)
    tv = (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16) if dtype == "bf16"
          else torch.from_numpy(v)).requires_grad_()
    out = ops.segment_sum_edges(csr, tv)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    assert tuple(out.shape) == (N,) + shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    (out ** 2).sum().backward()
    assert tv.grad.dtype == tv.dtype
    assert not tv.grad[E:].any()  # padding slots take no gradient
    np.testing.assert_allclose(tv.grad.float().numpy(), np.asarray(ref_grad, np.float32),
                               **(BF16_GRAD if dtype == "bf16" else TOL))


def test_segment_sum_edges_ignores_what_the_padding_holds(graphs):
    _, csr = graphs
    v = torch.from_numpy(_values((5,), "f32", 1))
    for vals in (v, v[:, 0], torch.cat([v] * 4, 1)):  # K = 5, (), K = 20
        poisoned = vals.clone()
        poisoned[E:] = float("nan")
        np.testing.assert_array_equal(ops.segment_sum_edges(csr, poisoned).numpy(),
                                      ops.segment_sum_edges(csr, vals).numpy())


def test_segment_sum_edges_routes_by_width(graphs, monkeypatch):
    """K3 up to MAX_NARROW_K columns, K1's no-gather mode past it, the
    no-gather sum's bf16 stream by the values' dtype alone; ``blocked`` is
    accepted and ignored; a CPU tensor loads no kernel library."""
    _, csr = graphs
    calls = []

    def no_library(*a, **k):
        raise AssertionError("a CPU tensor loaded a kernel library")

    real_narrow, real_wide = SK.segment_sum_narrow, SK.segment_sum_wide
    monkeypatch.setattr(kernel_lib, "load", no_library)
    monkeypatch.setattr(SK, "segment_sum_narrow", lambda c, v: calls.append(("K3", v.shape[1])) or real_narrow(c, v))
    monkeypatch.setattr(SK, "segment_sum_wide", lambda c, v, round_bf16=None: calls.append(
        ("nogather", v.shape[1], round_bf16)) or real_wide(c, v, round_bf16))
    for k in (1, SK.MAX_NARROW_K, SK.MAX_NARROW_K + 1):
        ops.segment_sum_edges(csr, torch.ones(CAP, k), blocked=object())
    ops.segment_sum_edges(csr, torch.ones(CAP, 24, dtype=torch.bfloat16))
    assert calls == [("K3", 1), ("K3", 16), ("nogather", 17, False), ("nogather", 24, True)]
    with pytest.raises(ValueError, match="capacity"):
        ops.segment_sum_edges(csr, torch.ones(E, 4))


def test_the_no_gather_sum_rounds_to_bf16_only_when_asked(graphs):
    """``round_bf16`` overrides the graph-size rule: f32 values stay f32 at
    any size, and the default keeps ``wide_stream_is_bf16``."""
    _, csr = graphs
    v = torch.from_numpy(_values((20,), "f32", 2)) * (1 + 2**-12)
    f32 = SK.segment_sum_wide(csr, v, round_bf16=False)
    bf16 = SK.segment_sum_wide(csr, v, round_bf16=True)
    np.testing.assert_array_equal(SK.segment_sum_wide(csr, v).numpy(), f32.numpy())  # a small graph: f32
    np.testing.assert_array_equal(bf16.numpy(), SK.segment_sum_wide(csr, v.bfloat16().float()).numpy())
    assert not torch.equal(f32, bf16)
