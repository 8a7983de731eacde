"""The port's segment and message ops, and K1's plain version, against the
JAX package on the same numpy inputs.

Tolerances: the same f32 arithmetic summed in another order, so 1e-5
relative plus 1e-5 absolute (inputs are O(1), rows hold tens of terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stgraph_tpu.graph.csr import build_csr as jax_build_csr
from stgraph_tpu.ops import message as JM
from stgraph_tpu.ops import segment as JS
from stgraph_tpu.ops import segment_pallas as NSP
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.ops import message as M
from stgraph_tpu_torch.ops import segment as S
from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(rng, n=40, e=150, capacity=None, empty=0):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - empty, e)  # the last `empty` rows get no edge
    return (
        build_csr(src, dst, n, capacity=capacity, device="cpu"),
        jax_build_csr(src, dst, n, capacity=capacity),
        src,
        dst,
    )


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("reduce", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_reductions_match_jax(rng, reduce, masked):
    csr, jcsr, *_ = _pair(rng, n=30, e=100, capacity=128, empty=4)
    data = rng.standard_normal((128, 4)).astype(np.float32)
    data[100:] = np.nan  # padding garbage must never leak
    data[:20:2] = data[1:20:2]  # adjacent duplicates: ties for max/min
    fn, jfn = {
        "sum": (S.segment_sum, JS.segment_sum),
        "max": (S.segment_max, JS.segment_max),
        "min": (S.segment_min, JS.segment_min),
        "mean": (S.segment_mean, JS.segment_mean),
    }[reduce]
    mask = csr.edge_mask if masked else None
    jmask = jcsr.edge_mask if masked else None
    out = fn(torch.from_numpy(data), csr.rows, 30, edge_mask=mask)
    ref = jfn(jnp.asarray(data), jcsr.rows, 30, edge_mask=jmask)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    assert np.isfinite(_np(out)).all()
    np.testing.assert_array_equal(_np(out)[-4:], 0.0)  # empty rows give 0


def test_segment_softmax_matches_jax(rng):
    csr, jcsr, *_ = _pair(rng, n=30, e=100, capacity=128, empty=3)
    scores = rng.standard_normal((128, 2)).astype(np.float32)
    out = S.segment_softmax(torch.from_numpy(scores), csr.rows, 30, edge_mask=csr.edge_mask)
    ref = JS.segment_softmax(jnp.asarray(scores), jcsr.rows, 30, edge_mask=jcsr.edge_mask)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean", "max", "softmax"])
def test_segment_grads_match_jax(rng, reduce):
    csr, jcsr, *_ = _pair(rng, n=30, e=100, capacity=128, empty=3)
    # distinct values: the max has no ties, so its gradient is defined alike
    data = (rng.permutation(256)[:128].reshape(128, 1) / 17.0).astype(np.float32)
    g = rng.standard_normal((128 if reduce == "softmax" else 30, 1)).astype(np.float32)
    fn, jfn = {
        "sum": (S.segment_sum, JS.segment_sum),
        "mean": (S.segment_mean, JS.segment_mean),
        "max": (S.segment_max, JS.segment_max),
        "softmax": (S.segment_softmax, JS.segment_softmax),
    }[reduce]
    x = torch.from_numpy(data).requires_grad_()
    (fn(x, csr.rows, 30, edge_mask=csr.edge_mask) * torch.from_numpy(g)).sum().backward()
    ref = jax.grad(lambda v: (jfn(v, jcsr.rows, 30, edge_mask=jcsr.edge_mask) * g).sum())(
        jnp.asarray(data)
    )
    np.testing.assert_allclose(x.grad.numpy(), _np(ref), **TOL)


def test_max_tie_gradient_is_shared_as_in_jax():
    rows = torch.tensor([0, 0, 0, 1, 2])  # 2 == num_segments: padding
    data = np.array([[1.0], [3.0], [3.0], [2.0], [9.0]], np.float32)
    x = torch.from_numpy(data).requires_grad_()
    S.segment_max(x, rows, 2).sum().backward()
    ref = jax.grad(lambda v: JS.segment_max(v, jnp.asarray(rows.numpy()), 2).sum())(jnp.asarray(data))
    np.testing.assert_allclose(x.grad.numpy(), _np(ref))
    np.testing.assert_allclose(x.grad.numpy().ravel(), [0, 0.5, 0.5, 1, 0])


@pytest.mark.parametrize("reduce", ["sum", "max", "min", "mean"])
def test_aggregate_matches_jax(rng, reduce):
    csr, jcsr, *_ = _pair(rng, empty=5)
    vals = rng.standard_normal((csr.capacity, 3)).astype(np.float32)
    out = M.aggregate(csr, torch.from_numpy(vals), reduce=reduce)
    ref = JM.aggregate(jcsr, jnp.asarray(vals), reduce=reduce)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("impl,jimpl", [("torch", "jnp"), ("dense", "dense"), ("kernel", "jnp")])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("f", [7, 16])
def test_spmm_matches_jax(rng, impl, jimpl, weighted, f):
    csr, jcsr, *_ = _pair(rng, capacity=160, empty=3)
    h = rng.standard_normal((40, f)).astype(np.float32)
    w = rng.standard_normal((csr.capacity, 1)).astype(np.float32) if weighted else None
    out = M.spmm(csr, torch.from_numpy(h), None if w is None else torch.from_numpy(w), impl=impl)
    ref = JM.spmm(jcsr, jnp.asarray(h), None if w is None else jnp.asarray(w), impl=jimpl)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_spmm_other_reductions_match_jax(rng, reduce):
    csr, jcsr, *_ = _pair(rng, empty=3)
    h = rng.standard_normal((40, 5)).astype(np.float32)
    out = M.spmm(csr, torch.from_numpy(h), reduce=reduce)
    ref = JM.spmm(jcsr, jnp.asarray(h), reduce=reduce, impl="jnp")
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_spmm_scalar_weight_and_bf16_dense(rng):
    csr, jcsr, *_ = _pair(rng)
    h = rng.standard_normal((40, 8)).astype(np.float32)
    out = M.spmm(csr, torch.from_numpy(h), torch.tensor(0.5), impl="torch")
    ref = JM.spmm(jcsr, jnp.asarray(h), jnp.asarray(0.5), impl="jnp")
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)
    # bf16 dense: same bf16 adjacency, f32 products, one rounding at the end
    hb = torch.from_numpy(h).to(torch.bfloat16)
    out = M.spmm(csr, hb, impl="dense")
    ref = JM.spmm(jcsr, jnp.asarray(h, jnp.bfloat16), impl="dense")
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), rtol=1e-2, atol=1e-2)


def test_csr_to_dense_and_edge_order_match_jax(rng):
    csr, jcsr, src, dst = _pair(rng, capacity=160)
    w = rng.random(csr.capacity).astype(np.float32)
    np.testing.assert_array_equal(
        M.csr_to_dense(csr, torch.from_numpy(w)).numpy(), _np(JM.csr_to_dense(jcsr, jnp.asarray(w)))
    )
    ed = rng.standard_normal((len(src), 2)).astype(np.float32)
    np.testing.assert_array_equal(
        M.edge_data_to_csr_order(csr, torch.from_numpy(ed)).numpy(),
        _np(JM.edge_data_to_csr_order(jcsr, jnp.asarray(ed))),
    )


@pytest.mark.parametrize("op", ["dot", "add", "mul"])
def test_sddmm_matches_jax(rng, op):
    csr, jcsr, *_ = _pair(rng, capacity=160)
    a = rng.standard_normal((40, 6)).astype(np.float32)
    b = rng.standard_normal((40, 6)).astype(np.float32)
    out = M.sddmm(csr, torch.from_numpy(a), torch.from_numpy(b), op=op)
    ref = JM.sddmm(jcsr, jnp.asarray(a), jnp.asarray(b), op=op)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


# K1's plain version against the Pallas kernel in interpret mode. The
# roundings are the same (bf16 stream: bf16 features, bf16 weights, bf16
# product, f32 sum), so only the order of f32 sums differs.
K1_CASES = [
    (47, True, None),
    (130, False, None),
    (100, True, "bf16"),
    (128, False, "bf16"),
    (7, True, "bf16"),
]


@pytest.mark.parametrize("f,weighted,stream", K1_CASES)
def test_k1_plain_matches_pallas_interpret(rng, f, weighted, stream):
    n, e = 300, 2500
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dst[dst > n - 20] = 0  # empty rows and one heavy row
    csr = build_csr(src, dst, n, device="cpu")
    jcsr = jax_build_csr(src, dst, n)
    x = rng.standard_normal((n, f)).astype(np.float32)
    w = rng.random((csr.capacity, 1)).astype(np.float32)
    w[e:] = 1e3  # padding weights must be unreachable
    sd = torch.bfloat16 if stream else None
    out, den = spmm_rowmask(
        csr, torch.from_numpy(w) if weighted else None, torch.from_numpy(x), stream_dtype=sd
    )
    ref, _ = NSP.spmm_rowmask(
        jcsr,
        jnp.asarray(w) if weighted else None,
        jnp.asarray(x),
        interpret=True,
        stream_dtype=jnp.bfloat16 if stream else None,
    )
    assert den is None and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _np(ref), **TOL)
    np.testing.assert_array_equal(out.numpy()[n - 19 :], 0.0)


@pytest.mark.parametrize("edge_block", [1, 37, 1000])
def test_k1_plain_edge_blocks_give_the_same_result(rng, edge_block):
    n, e = 120, 900
    src = rng.integers(0, n, e)
    dst = rng.integers(10, n - 10, e)  # empty rows at both ends
    csr = build_csr(src, dst, n, device="cpu")
    x = torch.from_numpy(rng.standard_normal((n, 9)).astype(np.float32))
    w = torch.from_numpy(rng.random(csr.capacity).astype(np.float32))
    whole = spmm_rowmask_plain(csr, w, x, torch.bfloat16)
    blocked = spmm_rowmask_plain(csr, w, x, torch.bfloat16, edge_block=edge_block)
    # each row's edges stay in one block, so the sums are the same sums
    assert torch.equal(whole, blocked)


def test_k1_plain_is_differentiable(rng):
    csr, jcsr, *_ = _pair(rng, capacity=160)
    x = rng.standard_normal((40, 8)).astype(np.float32)
    w = rng.random((160, 1)).astype(np.float32)
    g = rng.standard_normal((40, 8)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    (spmm_rowmask_plain(csr, wt, xt) * torch.from_numpy(g)).sum().backward()

    def loss(a, b):
        return (JM.spmm(jcsr, a, b, impl="jnp") * g).sum()

    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(xt.grad.numpy(), _np(dx), **TOL)
    e = csr.num_edges
    np.testing.assert_allclose(wt.grad.numpy()[:e], _np(dw)[:e], **TOL)
    np.testing.assert_array_equal(wt.grad.numpy()[e:], 0.0)


def test_k1_modes_of_later_slices_raise(rng):
    """K1's heads and denominator modes came with the composed GAT route's
    rowmask branch: a tiling the JAX kernel refuses (2 heads of F = 4:
    ``128 % F == 0`` but ``(H * F) % 128 != 0``) raises ``ValueError`` in
    both packages, and the denominator of unit weights is each row's
    in-degree."""
    csr, jcsr, _, dst = _pair(rng)
    x = torch.zeros(40, 8)
    with pytest.raises(ValueError, match="128 % F"):
        spmm_rowmask(csr, torch.ones(csr.capacity, 2), x, heads=2)
    with pytest.raises(ValueError, match="128 % F"):
        NSP.spmm_rowmask(jcsr, jnp.ones((csr.capacity, 2)), jnp.zeros((40, 8)), heads=2, interpret=True)
    out, den = spmm_rowmask(csr, torch.ones(csr.capacity, 1), x, with_denom=True)
    assert not out.any()
    np.testing.assert_array_equal(den.numpy()[:, 0], np.bincount(dst, minlength=40))
