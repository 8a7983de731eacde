"""K1, K2, K4, K8 and K9 on the card against their plain versions, and the
GCN forward, a GCN training step and a GAT training step on CUDA against
the CPU. Marked ``cuda``: they skip where no card is present. On a
machine with a card and without jax they run without the suite's conftest:
``python -m pytest tests/test_torch_cuda.py --noconftest``.

Tolerance: the kernel rounds as its plain version does (a bf16 stream
rounds features, weights and products to bf16 and sums in f32), so only
the order of f32 sums differs: 1e-4 of the output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import GATConv, GCNConv
from stgraph_tpu_torch.ops import flash_gat as FG
from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow, segment_max_narrow_plain
from stgraph_tpu_torch.ops.spmm_kernels import (
    ROW_CHUNK,
    spmm_rowmask,
    spmm_rowmask_bwd,
    spmm_rowmask_bwd_plain,
    spmm_rowmask_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _graph(rng, n, e, hub_deg):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 50, e)  # 50 empty rows
    dst[:hub_deg] = 7  # a hub row split across several warps
    return src, dst


@pytest.mark.parametrize("f", [47, 100, 128, 130])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k1_matches_plain_on_the_card(cuda, rng, f, weighted, stream):
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    csr = build_csr(src, dst, n, device=cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.random(csr.capacity).astype(np.float32)).to(cuda) if weighted else None
    before = spmm_rowmask.launches
    out, _ = spmm_rowmask(csr, w, x, stream_dtype=stream)
    torch.cuda.synchronize()
    assert spmm_rowmask.launches == before + 1
    ref = spmm_rowmask_plain(csr, w, x, stream)
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err
    assert not out[n - 50 :].any()


def test_gcn_forward_on_cuda_matches_cpu(cuda, rng):
    n, e = 5000, 250_000  # above the bf16-stream threshold: K1 streams bf16
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, 100)).astype(np.float32)
    conv = GCNConv(100, 128, activation=torch.relu, impl="kernel", device="cpu",
                   generator=torch.Generator().manual_seed(0))
    conv_cuda = GCNConv(100, 128, activation=torch.relu, impl="kernel", device=cuda)
    conv_cuda.load_state_dict(conv.state_dict())
    before = spmm_rowmask.launches
    with torch.inference_mode():
        ref = conv(StaticGraph(edges, None, n, device="cpu"), torch.from_numpy(x))
        out = conv_cuda(StaticGraph(edges, None, n, device=cuda), torch.from_numpy(x).to(cuda)).cpu()
    assert spmm_rowmask.launches == before + 1
    # h @ W sums in another order on the card, so a gathered value may round
    # to the neighbouring bf16 number: a bf16 ulp of one term, not 1e-4
    assert (out - ref).abs().max().item() <= 1e-2 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("f", [7, 47, 128, 130])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k2_matches_plain_on_the_card(cuda, rng, f, stream):
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    src[-3 * ROW_CHUNK:] = 11  # a hub in the transpose too
    csr_t = build_csr(src, dst, n, device=cuda).transpose()
    g = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    fs = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal(csr_t.capacity).astype(np.float32)).to(cuda)
    before = spmm_rowmask_bwd.launches
    dh, dw = spmm_rowmask_bwd(csr_t, w, g, fs, stream_dtype=stream)
    torch.cuda.synchronize()
    assert spmm_rowmask_bwd.launches == before + 1
    ref_dh, ref_dw = spmm_rowmask_bwd_plain(csr_t, w, g, fs, stream)
    for out, ref in ((dh, ref_dh), (dw, ref_dw)):
        err = (out - ref).abs().max().item()
        assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err
    assert not dw[csr_t.num_edges:].any()


def test_gcn_training_step_on_cuda_matches_cpu(cuda, rng):
    n, e = 5000, 250_000  # K1 and K2 stream bf16
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, 100)).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 47, n))
    gen = torch.Generator().manual_seed(0)
    init = [GCNConv(100, 64, device="cpu", generator=gen).state_dict(),
            GCNConv(64, 47, device="cpu", generator=gen).state_dict()]
    grads = []
    for dev in ("cpu", cuda):
        convs = [GCNConv(100, 64, activation=torch.relu, impl="kernel", device=dev),
                 GCNConv(64, 47, impl="kernel", device=dev)]
        for conv, state in zip(convs, init):
            conv.load_state_dict(state)
        g = StaticGraph(edges, None, n, device=dev)
        before = spmm_rowmask.launches, spmm_rowmask_bwd.launches
        logits = convs[1](g, convs[0](g, torch.from_numpy(x).to(dev)))
        torch.nn.functional.cross_entropy(logits, y.to(dev)).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            # two layers: K1 twice forward, K2 twice backward
            assert (spmm_rowmask.launches - before[0], spmm_rowmask_bwd.launches - before[1]) == (2, 2)
        grads.append([p.grad.cpu() for c in convs for p in c.parameters()])
    for ref, out in zip(*grads):
        # h @ W and its gradient sum in another order on the card, so a
        # streamed value may round to the neighbouring bf16 number
        assert (out - ref).abs().max().item() <= 1e-2 * max(1e-6, ref.abs().max().item())


def _close(out, ref, tol=1e-4):
    err = (out - ref).abs().max().item()
    assert err <= tol * max(1.0, ref.abs().max().item()), err


@pytest.mark.parametrize("k", [1, 8, 16])
def test_k4_matches_plain_on_the_card(cuda, rng, k):
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    csr = build_csr(src, dst, n, device=cuda)
    table = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda)
    before = segment_max_narrow.launches
    for index in (csr.cols, None):
        vals = table if index is not None else table[csr.cols_clamped.long()]
        out = segment_max_narrow(csr, vals, index=index)
        torch.cuda.synchronize()
        assert torch.equal(out, segment_max_narrow_plain(csr, vals, index=index))  # a max is exact
        assert not out[n - 50:].any()
    assert segment_max_narrow.launches == before + 2


def _flash_inputs(rng, cuda, n, h, f, hub_t=True):
    src, dst = _graph(rng, n, 60_000, hub_deg=5 * ROW_CHUNK + 3)
    if hub_t:
        src[-3 * ROW_CHUNK:] = 11  # a hub in the transpose too
    csr = build_csr(src, dst, n, device=cuda)
    el, er, c = (torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)).to(cuda) for _ in range(3))
    fs, gu = (torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(cuda) for _ in range(2))
    return csr, el, er, c, fs, gu


@pytest.mark.parametrize("h,f", [(8, 32), (1, 47), (8, 8), (4, 16), (2, 100), (3, 5)])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k8_and_k9_match_plain_on_the_card(cuda, rng, h, f, stream):
    n = 3000
    csr, el, er, c, fs, gu = _flash_inputs(rng, cuda, n, h, f)
    m = FG.stability_max(csr, el, er, 0.2)
    before = FG.flash_gat_fwd.launches, FG.flash_gat_bwd.launches
    for aux in (False, True):
        outs = FG.flash_gat_fwd(csr, el, er, m, fs, h, 0.2, stream, aux=aux)
        torch.cuda.synchronize()
        refs = FG.flash_gat_fwd_plain(csr, el, er, m, fs, h, 0.2, stream, aux=aux)
        for out, ref in zip(outs, refs):
            if ref is not None:
                _close(out, ref)
        assert not outs[0][n - 50:].any() and not outs[1][n - 50:].any()
    csr_t = csr.transpose()
    dfs, dl = FG.flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, 0.2, stream)
    torch.cuda.synchronize()
    ref_dfs, ref_dl = FG.flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, 0.2, stream)
    _close(dfs, ref_dfs)
    # dl's terms w lp (dw - c) cancel: held to its sum of absolute terms
    mass = FG.flash_gat_bwd_plain(csr_t, el, er, m, -c.abs(), gu.abs(), fs.abs(), h, 0.2, stream)[1]
    assert ((dl - ref_dl).abs() <= 1e-4 * mass + 1e-6).all()
    assert (FG.flash_gat_fwd.launches, FG.flash_gat_bwd.launches) == (before[0] + 2, before[1] + 1)


def test_gat_training_step_on_cuda_matches_cpu(cuda, rng):
    n, e = 5000, 250_000  # the flash kernels stream bf16
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, 100)).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 47, n))
    gen = torch.Generator().manual_seed(0)
    init = [GATConv(100, 32, 8, device="cpu", generator=gen).state_dict(),
            GATConv(256, 47, 1, device="cpu", generator=gen).state_dict()]
    grads = []
    for dev in ("cpu", cuda):
        convs = [GATConv(100, 32, 8, activation=torch.nn.functional.elu, device=dev),
                 GATConv(256, 47, 1, device=dev)]
        for conv, state in zip(convs, init):
            conv.load_state_dict(state)
        g = StaticGraph(edges, None, n, device=dev)
        counts = segment_max_narrow.launches, FG.flash_gat_fwd.launches, FG.flash_gat_bwd.launches
        h = convs[0](g, torch.from_numpy(x).to(dev)).reshape(n, -1)
        logits = convs[1](g, h).mean(1)
        torch.nn.functional.cross_entropy(logits, y.to(dev)).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            now = segment_max_narrow.launches, FG.flash_gat_fwd.launches, FG.flash_gat_bwd.launches
            assert tuple(a - b for a, b in zip(now, counts)) == (2, 2, 2)
        grads.append([p.grad.cpu() for c in convs for p in c.parameters()])
    for ref, out in zip(*grads):
        # the projections sum in another order on the card, so a streamed
        # value may round to the neighbouring bf16 number
        assert (out - ref).abs().max().item() <= 2e-2 * max(1e-6, ref.abs().max().item())
