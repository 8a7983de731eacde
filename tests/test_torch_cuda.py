"""K1 (with its heads, denominator and no-gather modes), K2 (with its heads
mode), K3, K4, K5, K6, K7, K8 and K9 (with their dropout mode, and the
in-kernel keep-mask hash bit for bit) and K10 on the card against their
plain versions, and the GCN forward, a GCN training step, GAT training
steps on the flash route (with and without attention dropout) and on the
composed route's blocked and rowmask branches, and TGCN on a lazy dynamic
store pair on CUDA against the CPU. Marked ``cuda``: they skip where no card
is present. On a machine with a card and without jax they run without the
suite's conftest:
``python -m pytest tests/test_torch_cuda.py --noconftest``.

Tolerance: the kernel rounds as its plain version does (a bf16 stream
rounds features, weights and products to bf16 and sums in f32), so only
the order of f32 sums differs: 1e-4 of the output's largest magnitude, or,
for sums whose terms cancel (K3, K10, K9's dl, the no-gather sum and the
heads modes), 2e-4 of each output's sum of absolute terms. K4 and K5 are
maxima: bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from stgraph_tpu_torch.graph.blocked import build_blocked
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import TGCN, GATConv, GCNConv
from stgraph_tpu_torch.ops import dyn_spmm as DS
from stgraph_tpu_torch.ops import flash_gat as FG
from stgraph_tpu_torch.ops import rowid_kernels as RK
from stgraph_tpu_torch.ops import segment_kernels as SK
from stgraph_tpu_torch.ops import spmm_blocked as SB
from stgraph_tpu_torch.ops.segment_kernels import (
    segment_max_narrow,
    segment_max_narrow_plain,
    segment_max_wide,
    segment_max_wide_plain,
    segment_sum_narrow,
    segment_sum_narrow_plain,
    segment_sum_wide,
    segment_sum_wide_plain,
)
from stgraph_tpu_torch.ops.spmm_blocked import segment_sum_blocked, segment_sum_blocked_plain
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


def _poison_k2(n, hf, capacity, heads, device):
    """Blocks of dh's and dw's shapes filled with NaN and freed; their
    addresses."""
    torch.cuda.empty_cache()
    a = torch.full((n, hf), float("nan"), device=device)
    b = torch.full((capacity, heads), float("nan"), device=device)
    ptrs = a.data_ptr(), b.data_ptr()
    del a, b
    return ptrs


def _k2_against_plain(csr_t, w, g, x, stream, heads):
    """K2 into NaN-poisoned dh and dw, one launch counted, both outputs
    within 2e-4 of their sums of absolute terms, padding slots 0."""
    spmm_rowmask_bwd(csr_t, w, g, x, stream_dtype=stream, heads=heads)  # the work items, built once
    ptrs = _poison_k2(csr_t.num_nodes, g.shape[1], csr_t.capacity, heads, g.device)
    before = spmm_rowmask_bwd.launches
    dh, dw = spmm_rowmask_bwd(csr_t, w, g, x, stream_dtype=stream, heads=heads)
    torch.cuda.synchronize()
    assert spmm_rowmask_bwd.launches == before + 1
    assert (dh.data_ptr(), dw.data_ptr()) == ptrs  # the outputs took the poisoned blocks
    assert not dh.isnan().any() and not dw.isnan().any()
    ref_dh, ref_dw = spmm_rowmask_bwd_plain(csr_t, w, g, x, stream, heads=heads)
    mass_dh, mass_dw = spmm_rowmask_bwd_plain(csr_t, w.abs(), g.abs(), x.abs(), stream, heads=heads)
    _within_mass(dh, ref_dh, mass_dh)
    _within_mass(dw, ref_dw, mass_dw)
    assert not dw[csr_t.num_edges:].any()


@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k2_one_head_at_every_width_into_poisoned_outputs(cuda, rng, stream):
    """K2 at one head at every width from 1 to 256: every lane group (1 to
    32 lanes an edge), one or two column tiles, f32 rows on their own
    stride (aligned-down loads where it is not a multiple of 4) and bf16
    rows padded to 8 columns; a hub in the transpose split into two items."""
    n = 400
    src, dst = _graph(rng, n, 6000, hub_deg=300)
    src[-1500:] = 11
    csr_t = build_csr(src, dst, n, capacity=6005, device=cuda).transpose()
    for f in range(1, 257):
        g, x = (torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda) for _ in range(2))
        w = torch.from_numpy(rng.standard_normal(csr_t.capacity).astype(np.float32)).to(cuda)
        _k2_against_plain(csr_t, w, g, x, stream, 1)


@pytest.mark.parametrize("h,f", [(32, 4), (4, 32), (64, 2), (1, 200)])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
@pytest.mark.parametrize("chunk", [37, 128])
def test_k2_heads_and_split_hubs_with_short_items_into_poisoned_outputs(cuda, rng, monkeypatch, h, f, stream, chunk):
    """K2's heads tilings (a lane's columns two or four whole heads, or a
    head over several lanes) and one head at 200 columns, with hubs in
    both directions split into items of 37 edges (ending inside a group's
    step and inside a round) and of 128."""
    from stgraph_tpu_torch.ops import spmm_kernels as SKN

    monkeypatch.setitem(SKN.K2_CHUNK, "one_head", chunk)
    monkeypatch.setitem(SKN.K2_CHUNK, "heads", chunk)
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    src[-3 * ROW_CHUNK:] = 11
    csr_t = build_csr(src, dst, n, capacity=e + 5, device=cuda).transpose()
    g, x = (torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(cuda) for _ in range(2))
    w = torch.from_numpy(rng.random((csr_t.capacity, h)).astype(np.float32)).to(cuda)
    _k2_against_plain(csr_t, w, g, x, stream, h)


@pytest.mark.parametrize("k", list(range(1, 17)))
@pytest.mark.parametrize("chunk", [1024, 37, 128])
def test_k4_every_width_into_poisoned_outputs(cuda, rng, monkeypatch, k, chunk):
    """K4 at every width 1-16, indexed and per edge, with a table aligned
    for vector loads and one 4 B off (scalar loads), with hubs split into
    items of the port's length and of short ones: bit for bit against its
    plain version into NaN-poisoned outputs, empty rows 0, rows of negative
    values keeping their negative maxima, twice in a row (the split rows'
    tickets left at zero)."""
    from stgraph_tpu_torch.ops import segment_kernels as SEG

    monkeypatch.setattr(SEG, "K4_CHUNK", chunk)
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    csr = build_csr(src, dst, n, capacity=e + 5, device=cuda)
    for index in (csr.cols, None):
        rows = n if index is not None else csr.capacity
        vals = rng.standard_normal((rows, k)).astype(np.float32)
        vals[:, : (k + 1) // 2] = -np.abs(vals[:, : (k + 1) // 2])  # columns of negative maxima
        for misaligned in (False, True):
            t = torch.from_numpy(vals).to(cuda)
            if misaligned:
                t = torch.empty(rows * k + 1, device=cuda)[1:].view(rows, k).copy_(t)
            ref = segment_max_narrow_plain(csr, t, index=index)
            segment_max_narrow(csr, t, index=index)  # the work items, built once
            for _ in range(2):
                ptr = _poison((n, k), cuda)
                before = segment_max_narrow.launches
                out = segment_max_narrow(csr, t, index=index)
                torch.cuda.synchronize()
                assert segment_max_narrow.launches == before + 1
                assert out.data_ptr() == ptr  # the output took the poisoned block
                assert torch.equal(out, ref)
                assert not out[n - 50:].any() and (out[: n - 50, 0] < 0).all()


def _within_mass(out, ref, mass, tol=2e-4):
    assert ((out - ref).abs() <= tol * mass + 1e-6).all(), ((out - ref).abs() / mass.clamp(min=1e-30)).max()


@pytest.mark.parametrize("k", [1, 4, 6, 16])
def test_k3_matches_plain_on_the_card(cuda, rng, monkeypatch, k):
    """K3 on the forward and transpose CSRs of a graph with a hub each way
    (split into items of the port's length and of 37 edges), padding slots
    and 50 empty rows, against its plain version within 2e-4 of each
    output's sum of absolute terms, into NaN-poisoned outputs: one launch a
    call by the profiler, two calls bit-equal (hub rows included), the
    split rows' tickets back at 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    src[-3 * ROW_CHUNK:] = 11  # a hub in the transpose too
    csr = build_csr(src, dst, n, capacity=e + 5, device=cuda)  # with padding slots
    vals = torch.from_numpy(rng.standard_normal((csr.capacity, k)).astype(np.float32)).to(cuda)
    for chunk in (SK.K3_CHUNK, 37):
        monkeypatch.setattr(SK, "K3_CHUNK", chunk)
        for c in (csr, csr.transpose()):
            ref, mass = segment_sum_narrow_plain(c, vals), segment_sum_narrow_plain(c, vals.abs())
            segment_sum_narrow(c, vals)  # the plan, built once
            outs = []
            for _ in range(2):
                ptr = _poison((n, k), cuda)
                before = segment_sum_narrow.launches
                out = segment_sum_narrow(c, vals)
                torch.cuda.synchronize()
                assert segment_sum_narrow.launches == before + 1
                assert out.data_ptr() == ptr  # the output took the poisoned block
                _within_mass(out, ref, mass)
                outs.append(out)
            assert torch.equal(outs[0], outs[1])  # the same sums, hub rows included
            tickets = SK._k3_plan(c, chunk, k)[2]
            assert tickets.numel() >= 1 and not tickets.any()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                segment_sum_narrow(c, vals)
                torch.cuda.synchronize()
            kernels = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
            assert len(kernels) == 1 and "segment_sum_narrow" in kernels[0], kernels
    assert not segment_sum_narrow(csr, vals)[n - 50:].any()


def _poison(shape, device):
    """Fill a block of ``shape`` f32 with NaN and free it; returns its address.
    The caching allocator hands the block to the next allocation of that
    size, so a kernel output row left unwritten shows as NaN."""
    torch.cuda.empty_cache()
    t = torch.full(shape, float("nan"), dtype=torch.float32, device=device)
    ptr = t.data_ptr()
    del t
    return ptr


def _k10_graph(rng, cuda):
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)  # block 0 holds over 5000 slots
    src[-3 * ROW_CHUNK:] = 11
    dst = np.where(dst // 128 == 9, 0, dst)  # an empty block
    return n, build_csr(src, dst, n, device=cuda)


@pytest.mark.parametrize("h,f", [(4, 256), (6, 121), (3, 20), (3, 7), (40, 4)])
@pytest.mark.parametrize("misaligned", [False, True])
def test_k10_matches_plain_on_the_card(cuda, rng, h, f, misaligned):
    n, csr = _k10_graph(rng, cuda)
    x = torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(cuda)
    if misaligned:  # a table 4 B off a 16 B boundary: 4 B loads, up to four pieces a panel
        x = torch.empty(n * h * f + 1, device=cuda)[1:].view(n, h * f).copy_(x)
        assert SB.k10_panels(f, h * f, math.gcd(x.data_ptr(), 16))[0] == 1
    before = segment_sum_blocked.launches
    for transpose in (False, True):
        blk = build_blocked(csr.transpose() if transpose else csr)
        w = torch.from_numpy(rng.standard_normal((blk.capacity, h)).astype(np.float32)).to(cuda)
        out = segment_sum_blocked(blk, w, x, h)
        torch.cuda.synchronize()
        mass = segment_sum_blocked_plain(blk, w.abs(), x.abs(), h)
        _within_mass(out, segment_sum_blocked_plain(blk, w, x, h), mass)
        if not transpose:  # empty rows and the empty block
            assert not out[n - 50:].any() and not out[9 * 128:10 * 128].any()
    assert segment_sum_blocked.launches == before + 2


@pytest.mark.parametrize("h,f", [(4, 256), (6, 121), (3, 7)])
def test_k10_writes_every_row_of_a_poisoned_output(cuda, rng, h, f):
    n, csr = _k10_graph(rng, cuda)
    blk = build_blocked(csr)
    x = torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.random((blk.capacity, h)).astype(np.float32)).to(cuda)
    segment_sum_blocked(blk, w, x, h)  # the work items, built once
    ptr = _poison((n, h * f), cuda)
    out = segment_sum_blocked(blk, w, x, h)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr  # the output took the poisoned block
    assert not out.isnan().any()
    _within_mass(out, segment_sum_blocked_plain(blk, w, x, h), segment_sum_blocked_plain(blk, w, x.abs(), h))


def _k1_case(rng, cuda, n=3000, e=60_000):
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    return build_csr(src, dst, n, capacity=e + 5, device=cuda)


@pytest.mark.parametrize("f", [1, 3, 4, 5, 8, 16, 17, 47, 64, 100, 124, 125, 126, 200, 300])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
@pytest.mark.parametrize("misaligned", [False, True])
def test_k1_lane_groups_match_plain_at_every_width(cuda, rng, f, stream, misaligned):
    """K1 at one head, weighted with the denominator and unweighted, at widths
    that take every lane group (1 to 32 lanes an edge) and one to three
    column tiles; with a table 4 B off a 16 B boundary an f32 stream takes
    the aligned-down loads (a bf16 stream gets an aligned copy)."""
    n = 3000
    csr = _k1_case(rng, cuda, n)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    if misaligned:
        x = torch.empty(n * f + 1, device=cuda)[1:].view(n, f).copy_(x)
    w = torch.from_numpy(rng.standard_normal(csr.capacity).astype(np.float32)).to(cuda)
    for ww in (w, None):
        out, den = spmm_rowmask(csr, ww, x, with_denom=ww is not None, stream_dtype=stream)
        torch.cuda.synchronize()
        absw = None if ww is None else ww.abs()
        if ww is None:
            ref = spmm_rowmask_plain(csr, ww, x, stream)
        else:
            ref, ref_den = spmm_rowmask_plain(csr, ww, x, stream, with_denom=True)
            mass_den = spmm_rowmask_plain(csr, absw, x, stream, with_denom=True)[1]
            _within_mass(den, ref_den, mass_den)
        _within_mass(out, ref, spmm_rowmask_plain(csr, absw, x.abs(), stream))
        assert not out[n - 50:].any()


@pytest.mark.parametrize("case", ["f32 47", "f32 64", "f32 200 misaligned", "bf16 47", "bf16 128", "bf16 300",
                                  "heads 32x4 f32", "heads 32x4 bf16", "heads 128x1 bf16", "traced 47",
                                  "nogather 32", "nogather 130"])
def test_k1_writes_every_row_of_a_poisoned_output(cuda, rng, case):
    """Each K1 mode into an output block filled with NaN and freed just
    before: only split rows are zeroed, every other row is stored once."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_traced

    n = 3000
    csr = _k1_case(rng, cuda, n)
    kind, rest = case.split(" ", 1)
    if kind == "nogather":
        k = int(rest)
        vals = torch.from_numpy(rng.standard_normal((csr.capacity, k)).astype(np.float32)).to(cuda)
        segment_sum_wide(csr, vals)  # the work items, built once
        ptr = _poison((n, k), cuda)
        out = segment_sum_wide(csr, vals)
        ref, mass = segment_sum_wide_plain(csr, vals), segment_sum_wide_plain(csr, vals.abs())
    else:
        heads, f = (1, int(rest.split()[0])) if kind != "heads" else map(int, rest.split()[0].split("x"))
        stream = torch.bfloat16 if "bf16" in case else None
        x = torch.from_numpy(rng.standard_normal((n, heads * f)).astype(np.float32)).to(cuda)
        if "misaligned" in case:
            x = torch.empty(x.numel() + 1, device=cuda)[1:].view(n, heads * f).copy_(x)
        w = torch.from_numpy(rng.random((csr.capacity, heads)).astype(np.float32)).to(cuda)
        if kind == "traced":
            run = lambda: spmm_rowmask_traced(csr, None, x)[0]  # noqa: E731
            ref_w = None
        else:
            run = lambda: spmm_rowmask(csr, w, x, heads=heads, with_denom=heads > 1, stream_dtype=stream)[0]  # noqa: E731
            ref_w = w
        run()  # the work items, built once
        ptr = _poison((n, heads * f), cuda)
        out = run()
        ref = spmm_rowmask_plain(csr, ref_w, x, stream, heads=heads)
        mass = spmm_rowmask_plain(csr, ref_w, x.abs(), stream, heads=heads)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr  # the output took the poisoned block
    assert not out.isnan().any()
    _within_mass(out, ref, mass)


def test_k1_packed_bf16_product_is_the_first_designs_bit_for_bit(cuda):
    """The packed product K1 forms in bf16 (mul.rn.bf16x2) against the first
    design's round_to_bf16(__fmul_rn(x, w)) over all 2^32 pairs of bf16 bit
    patterns: subnormal, overflowing and signed-zero products included."""
    from stgraph_tpu_torch.ops import kernel_lib
    from stgraph_tpu_torch.ops.spmm_kernels import _SIGNATURES

    lib = kernel_lib.load("spmm_rowmask", _SIGNATURES)
    res = torch.tensor([0, 0, -1], dtype=torch.int64, device=cuda)
    assert lib.stg_bf16_product_check(0, 1 << 32, res.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    bad, nans, first = res.tolist()
    assert bad == 0, (bad, hex(first & (2**64 - 1)))
    assert nans > 0  # NaN inputs were among the pairs


@pytest.mark.parametrize("k", [17, 32, 130])
def test_k5_matches_plain_on_the_card(cuda, rng, k):
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    csr = build_csr(src, dst, n, capacity=e + 5, device=cuda)  # with padding slots
    vals = torch.from_numpy(rng.standard_normal((csr.capacity, k)).astype(np.float32)).to(cuda)
    before = segment_max_wide.launches
    out = segment_max_wide(csr, vals)
    torch.cuda.synchronize()
    assert segment_max_wide.launches == before + 1
    assert torch.equal(out, segment_max_wide_plain(csr, vals))  # a max is exact
    assert not out[n - 50:].any()


@pytest.mark.parametrize("k", [5, 17, 32, 130])
@pytest.mark.parametrize("chunk", [128, 37])
def test_k5_split_hubs_in_one_launch_into_poisoned_outputs(cuda, rng, monkeypatch, k, chunk):
    """K5 with hubs split into items of the port's length and of a short
    one, at widths of one column tile and of three (130: 64 + 64 + 2),
    unaligned (scalar loads) and aligned, with a row of -inf, -0.0 values
    and all-negative columns: one launch a call, bit for bit against its
    plain version into NaN-poisoned outputs, twice in a row, the split
    rows' tickets back at 0 and their scratch rows at -inf after each."""
    monkeypatch.setattr(SK, "K5_CHUNK", chunk)
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    dst[-700:] = 11  # a second hub
    csr = build_csr(src, dst, n, capacity=e + 5, device=cuda)
    vals = rng.standard_normal((csr.capacity, k)).astype(np.float32)
    vals[:, : (k + 1) // 2] = -np.abs(vals[:, : (k + 1) // 2])  # columns of negative maxima
    vals[csr.rows.cpu().numpy() == 13] = -np.inf
    vals[rng.integers(0, csr.capacity, 500)] = -0.0
    t = torch.from_numpy(vals).to(cuda)
    ref = segment_max_wide_plain(csr, t)
    segment_max_wide(csr, t)  # the work items, built once
    items, split_items, tickets, scratch = SK._k5_plan(csr, chunk, k)
    assert split_items.numel() >= 2 and (split_items > 1).all()
    for _ in range(2):
        ptr = _poison((n, k), cuda)
        before = segment_max_wide.launches
        out = segment_max_wide(csr, t)
        torch.cuda.synchronize()
        assert segment_max_wide.launches == before + 1
        assert out.data_ptr() == ptr  # the output took the poisoned block
        assert torch.equal(out, ref)
        assert not tickets.any() and torch.isneginf(scratch).all()
        assert not out[n - 50:].any() and not out[13].any()


@pytest.mark.parametrize("k", [17, 32, 130])
@pytest.mark.parametrize("bf16", [False, True])
def test_wide_sum_matches_plain_on_the_card(cuda, rng, monkeypatch, k, bf16):
    if bf16:
        monkeypatch.setattr(SK, "WIDE_BF16_MIN_SLOTS", 0)  # every graph streams bf16
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    src[-3 * ROW_CHUNK:] = 11  # a hub in the transpose too
    csr = build_csr(src, dst, n, capacity=e + 5, device=cuda)
    vals = torch.from_numpy(rng.standard_normal((csr.capacity, k)).astype(np.float32)).to(cuda)
    assert SK.wide_stream_is_bf16(csr, vals) == bf16
    before = segment_sum_wide.launches
    for c in (csr, csr.transpose()):
        out = segment_sum_wide(c, vals)
        torch.cuda.synchronize()
        _within_mass(out, segment_sum_wide_plain(c, vals), segment_sum_wide_plain(c, vals.abs()))
    assert not segment_sum_wide(csr, vals)[n - 50:].any()
    assert segment_sum_wide.launches == before + 3


@pytest.mark.parametrize("h,f", [(32, 4), (8, 64), (4, 128), (64, 2), (1, 384)])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k1_and_k2_heads_modes_match_plain_on_the_card(cuda, rng, h, f, stream):
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    src[-3 * ROW_CHUNK:] = 11  # a hub in the transpose too
    csr = build_csr(src, dst, n, capacity=e + 5, device=cuda)
    csr_t = csr.transpose()
    x, g = (torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(cuda) for _ in range(2))
    w = torch.from_numpy(rng.random((csr.capacity, h)).astype(np.float32)).to(cuda)
    before = spmm_rowmask.launches, spmm_rowmask_bwd.launches
    out, den = spmm_rowmask(csr, w, x, heads=h, with_denom=True, stream_dtype=stream)
    dh, dw = spmm_rowmask_bwd(csr_t, w, g, x, stream_dtype=stream, heads=h)
    torch.cuda.synchronize()
    assert (spmm_rowmask.launches, spmm_rowmask_bwd.launches) == (before[0] + 1, before[1] + 1)
    ref, ref_den = spmm_rowmask_plain(csr, w, x, stream, heads=h, with_denom=True)
    _within_mass(out, ref, spmm_rowmask_plain(csr, w, x.abs(), stream, heads=h))
    _within_mass(den, ref_den, ref_den)  # positive weights: the sum is its own mass
    assert not out[n - 50:].any() and not den[n - 50:].any()
    ref_dh, ref_dw = spmm_rowmask_bwd_plain(csr_t, w, g, x, stream, heads=h)
    mass_dh, mass_dw = spmm_rowmask_bwd_plain(csr_t, w, g.abs(), x.abs(), stream, heads=h)
    _within_mass(dh, ref_dh, mass_dh)
    _within_mass(dw, ref_dw, mass_dw)
    assert not dw[csr_t.num_edges:].any()


def test_rowmask_gat_training_step_on_cuda_matches_cpu(cuda, rng):
    """``benchmarking/gat/train.py --num_heads 32 --num_hidden 4``'s two
    layers (32 x 4 with ELU, then 1 x 3): the rowmask branch (K5, K1 with
    heads and the denominator; K2 with heads, the no-gather sum twice) and
    the flash route (K4, K8; K9), f32 throughout."""
    n, e = 5000, 150_000
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, 50)).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 3, n))
    gen = torch.Generator().manual_seed(0)
    init = [GATConv(50, 4, 32, device="cpu", generator=gen).state_dict(),
            GATConv(128, 3, 1, device="cpu", generator=gen).state_dict()]
    counters = (spmm_rowmask, spmm_rowmask_bwd, segment_max_wide, segment_sum_wide, segment_max_narrow,
                FG.flash_gat_fwd, FG.flash_gat_bwd)
    grads = []
    for dev in ("cpu", cuda):
        convs = [GATConv(50, 4, 32, activation=torch.nn.functional.elu, impl="sparse", device=dev),
                 GATConv(128, 3, 1, impl="sparse", device=dev)]
        for conv, state in zip(convs, init):
            conv.load_state_dict(state)
        g = StaticGraph(edges, None, n, device=dev)
        counts = [k.launches for k in counters]
        h = convs[0](g, torch.from_numpy(x).to(dev)).reshape(n, -1)
        logits = convs[1](g, h).mean(1)
        torch.nn.functional.cross_entropy(logits, y.to(dev)).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert [k.launches - c for k, c in zip(counters, counts)] == [1, 1, 1, 2, 1, 1, 1]
        grads.append([p.grad.cpu() for c in convs for p in c.parameters()])
    for ref, out in zip(*grads):
        assert (out - ref).abs().max().item() <= 1e-3 * max(1e-6, ref.abs().max().item())


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


def test_in_kernel_keep_mask_is_edge_keep_mask_bit_for_bit(cuda, rng):
    """The hash K8 and K9 run in registers (``csrc/edge_keep_mask.cuh``,
    through ``stg_edge_keep_mask``) against the port's ``edge_keep_mask``."""
    e = 1_000_000
    src = torch.from_numpy(rng.integers(0, 2**31 - 1, e)).int()
    dst = torch.from_numpy(rng.integers(0, 2**31 - 1, e)).int()
    for seed in (0, 2**32 - 1, 2_654_435_761):
        for h, rate in ((8, 0.6), (1, 0.35), (21, 0.1)):
            seed_dev = torch.tensor([seed], device=cuda)
            out = FG.edge_keep_mask_kernel(src.to(cuda), dst.to(cuda), seed_dev, h, rate)
            torch.cuda.synchronize()
            ref = FG.edge_keep_mask(src, dst, seed, h, rate)
            assert torch.equal(out.cpu().view(torch.int32), ref.view(torch.int32)), (seed, h, rate)


@pytest.mark.parametrize("h,f", [(8, 32), (1, 47), (8, 8), (4, 16), (3, 5)])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
@pytest.mark.parametrize("rate", [0.3, 0.6])
def test_k8_and_k9_dropout_mode_match_plain_on_the_card(cuda, rng, h, f, stream, rate):
    n = 3000
    csr, el, er, c, fs, gu = _flash_inputs(rng, cuda, n, h, f)
    seed = torch.tensor([3_000_000_019], device=cuda)
    m = FG.stability_max(csr, el, er, 0.2)
    before = FG.flash_gat_fwd.dropout_launches, FG.flash_gat_bwd.dropout_launches
    for aux in (False, True):
        outs = FG.flash_gat_fwd(csr, el, er, m, fs, h, 0.2, stream, aux=aux, rate=rate, seed=seed)
        torch.cuda.synchronize()
        refs = FG.flash_gat_fwd_plain(csr, el, er, m, fs, h, 0.2, stream, aux, None, rate, seed)
        # out and u against their sums of absolute terms (the plain version on |fs|)
        masses = FG.flash_gat_fwd_plain(csr, el, er, m, fs.abs(), h, 0.2, stream, aux, None, rate, seed)
        for out, ref, mass in zip(outs, refs, masses):
            if ref is not None:
                assert ((out - ref).abs() <= 1e-4 * mass + 1e-6).all()
        undropped = FG.flash_gat_fwd(csr, el, er, m, fs, h, 0.2, stream, aux=aux)
        torch.cuda.synchronize()
        _close(outs[1], undropped[1])  # den keeps the undropped weights
        assert not torch.allclose(outs[0], undropped[0])
    csr_t = csr.transpose()
    dfs, dl = FG.flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, 0.2, stream, rate=rate, seed=seed)
    torch.cuda.synchronize()
    ref_dfs, ref_dl = FG.flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, 0.2, stream, None, rate, seed)
    mass_dfs, mass_dl = FG.flash_gat_bwd_plain(csr_t, el, er, m, -c.abs(), gu.abs(), fs.abs(), h, 0.2, stream, None,
                                               rate, seed)
    assert ((dfs - ref_dfs).abs() <= 1e-4 * mass_dfs + 1e-6).all()
    assert ((dl - ref_dl).abs() <= 1e-4 * mass_dl + 1e-6).all()
    assert (FG.flash_gat_fwd.dropout_launches, FG.flash_gat_bwd.dropout_launches) == (before[0] + 2, before[1] + 1)


def _flash_against_plain(csr, el, er, c, fs, gu, h, stream, rate=0.0, seed=None, poison=False, tol=2e-4):
    """K8 (with and without aux) and K9 against their plain versions, every
    output to ``tol`` of its sum of absolute terms; with ``poison`` each
    call's first output (out, dfs) takes a block filled with NaN just
    before."""
    n, hf = fs.shape
    m = FG.stability_max(csr, el, er, 0.2)
    sd = seed if rate else None

    def call(fn):
        ptr = _poison((n, hf), fs.device) if poison else None
        res = fn()
        torch.cuda.synchronize()
        assert ptr is None or res[0].data_ptr() == ptr  # the output took the poisoned block
        return res

    for aux in (False, True):
        outs = call(lambda: FG.flash_gat_fwd(csr, el, er, m, fs, h, 0.2, stream, aux=aux, rate=rate, seed=sd))
        refs = FG.flash_gat_fwd_plain(csr, el, er, m, fs, h, 0.2, stream, aux, None, rate, sd)
        masses = FG.flash_gat_fwd_plain(csr, el, er, m, fs.abs(), h, 0.2, stream, aux, None, rate, sd)
        for out, ref, mass in zip(outs, refs, masses):
            if ref is not None:
                assert not out.isnan().any()
                _within_mass(out, ref, mass, tol)
    csr_t = csr.transpose()
    dfs, dl = call(lambda: FG.flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, 0.2, stream, rate=rate, seed=sd))
    ref_dfs, ref_dl = FG.flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, 0.2, stream, None, rate, sd)
    mass_dfs, mass_dl = FG.flash_gat_bwd_plain(csr_t, el, er, m, -c.abs(), gu.abs(), fs.abs(), h, 0.2, stream,
                                               None, rate, sd)
    assert not dfs.isnan().any() and not dl.isnan().any()
    _within_mass(dfs, ref_dfs, mass_dfs, tol)
    _within_mass(dl, ref_dl, mass_dl, tol)


@pytest.mark.parametrize("h,f", [(8, 32), (1, 47), (3, 5), (16, 16)])
@pytest.mark.parametrize("mode", ["aux and no aux", "dropout 0.3", "dropout 0.6"])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k8_and_k9_write_every_row_of_a_poisoned_output(cuda, rng, h, f, mode, stream):
    """K8 (with and without aux, and in the dropout mode) and K9 into output
    blocks filled with NaN and freed just before: only split rows are
    zeroed, every other row is stored once."""
    n = 3000
    csr, el, er, c, fs, gu = _flash_inputs(rng, cuda, n, h, f)
    rate = float(mode.split()[1]) if mode.startswith("dropout") else 0.0
    seed = torch.tensor([2_718_281_828], device=cuda)
    FG.flash_gat_fwd(csr, el, er, FG.stability_max(csr, el, er, 0.2), fs, h, 0.2, stream)  # items built once
    _flash_against_plain(csr, el, er, c, fs, gu, h, stream, rate, seed, poison=True)


@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k8_and_k9_one_head_at_every_width(cuda, rng, stream):
    """H = 1 at every width from 1 to 256: every lane group (1 to 32 lanes
    an edge, one or two loads a lane) and every padded row stride."""
    n = 400
    src, dst = _graph(rng, n, 6000, hub_deg=1500)
    csr = build_csr(src, dst, n, device=cuda)
    for f in range(1, 257):
        el, er, c = (torch.from_numpy(rng.standard_normal((n, 1)).astype(np.float32)).to(cuda) for _ in range(3))
        fs, gu = (torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda) for _ in range(2))
        _flash_against_plain(csr, el, er, c, fs, gu, 1, stream)


@pytest.mark.parametrize("h,f", [
    (8, 1), (3, 3), (4, 4), (16, 1), (2, 8), (11, 3), (4, 8), (13, 5), (16, 4), (3, 43), (16, 8), (2, 100),
    (16, 16), (2, 128), (4, 64),
])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k8_and_k9_at_every_lane_group_boundary(cuda, rng, h, f, stream):
    """Several heads on each side of every lane-group boundary (rows of
    4, 8, 16, 32, 64 and 128 columns and one past, in both streams; 256
    f32 columns take two loads a lane), heads not a power of two among
    them, and a lane's columns spanning heads (F not a multiple of them)."""
    csr, el, er, c, fs, gu = _flash_inputs(rng, cuda, 3000, h, f)
    _flash_against_plain(csr, el, er, c, fs, gu, h, stream)


@pytest.mark.parametrize("chunk", [37, 128])
@pytest.mark.parametrize("h,f,stream", [(8, 32, torch.bfloat16), (1, 47, torch.bfloat16), (8, 8, None),
                                        (1, 3, None), (4, 32, None)])
def test_k8_and_k9_split_hubs_and_items_ending_inside_an_edge_step(cuda, rng, monkeypatch, chunk, h, f, stream):
    """A hub split into several items in the forward CSR and in its
    transpose, at item lengths of 128 edges and of 37 (so items end inside
    a lane group's step at every width, and inside a round), with and
    without dropout."""
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    monkeypatch.setitem(SK.FLASH_CHUNK, "fwd", chunk)
    monkeypatch.setitem(SK.FLASH_CHUNK, "bwd", chunk)
    csr, el, er, c, fs, gu = _flash_inputs(rng, cuda, 3000, h, f)
    seed = torch.tensor([31_415_926], device=cuda)
    for rate in (0.0, 0.6):
        _flash_against_plain(csr, el, er, c, fs, gu, h, stream, rate, seed, poison=True)


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


def test_attention_dropout_gat_training_step_on_cuda_matches_cpu(cuda, rng):
    """GATConv(100, 32, 8) -> GATConv(256, 47, 1) with ``attn_drop`` 0.6:
    route (a) on the card, K8's and K9's dropout mode (2 each, no plain
    torch), against the same layers on the CPU with the same seeds (drawn
    from a CPU generator on both sides)."""
    n, e = 5000, 250_000
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, 100)).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 47, n))
    gen = torch.Generator().manual_seed(0)
    init = [GATConv(100, 32, 8, device="cpu", generator=gen).state_dict(),
            GATConv(256, 47, 1, device="cpu", generator=gen).state_dict()]
    counters = (segment_max_narrow, "launches"), (FG.flash_gat_fwd, "dropout_launches"), \
        (FG.flash_gat_bwd, "dropout_launches")
    grads = []
    for dev in ("cpu", cuda):
        convs = [GATConv(100, 32, 8, attn_drop=0.6, activation=torch.nn.functional.elu, device=dev),
                 GATConv(256, 47, 1, attn_drop=0.6, device=dev)]
        for conv, state in zip(convs, init):
            conv.load_state_dict(state)
            conv.train()
        g = StaticGraph(edges, None, n, device=dev)
        seeds = torch.Generator().manual_seed(7)
        counts = [getattr(k, a) for k, a in counters]
        h = convs[0](g, torch.from_numpy(x).to(dev), generator=seeds).reshape(n, -1)
        logits = convs[1](g, h, generator=seeds).mean(1)
        torch.nn.functional.cross_entropy(logits, y.to(dev)).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert [getattr(k, a) - c for (k, a), c in zip(counters, counts)] == [2, 2, 2]
        grads.append([p.grad.cpu() for c in convs for p in c.parameters()])
    for ref, out in zip(*grads):
        assert (out - ref).abs().max().item() <= 2e-2 * max(1e-6, ref.abs().max().item())


def test_composed_gat_training_step_on_cuda_matches_cpu(cuda, rng):
    """Two layers off the flash route (4 x 72 with ELU, then 6 x 47
    averaged): K4, K3 and K10 forward, K10 and K3 backward, f32 throughout."""
    n, e = 5000, 250_000
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, 50)).astype(np.float32)
    y = torch.from_numpy(rng.integers(0, 47, n))
    gen = torch.Generator().manual_seed(0)
    init = [GATConv(50, 72, 4, device="cpu", generator=gen).state_dict(),
            GATConv(288, 47, 6, device="cpu", generator=gen).state_dict()]
    counters = (segment_sum_narrow, segment_max_narrow, segment_sum_blocked)
    grads = []
    for dev in ("cpu", cuda):
        convs = [GATConv(50, 72, 4, activation=torch.nn.functional.elu, device=dev),
                 GATConv(288, 47, 6, device=dev)]
        for conv, state in zip(convs, init):
            conv.load_state_dict(state)
        g = StaticGraph(edges, None, n, device=dev)
        counts = [k.launches for k in counters]
        h = convs[0](g, torch.from_numpy(x).to(dev)).reshape(n, -1)
        logits = convs[1](g, h).mean(1)
        torch.nn.functional.cross_entropy(logits, y.to(dev)).backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert [k.launches - c for k, c in zip(counters, counts)] == [6, 2, 4]  # K3, K4, K10
        grads.append([p.grad.cpu() for c in convs for p in c.parameters()])
    for ref, out in zip(*grads):
        assert (out - ref).abs().max().item() <= 1e-3 * max(1e-6, ref.abs().max().item())


def _rowid_store(rng, n, slots, hub_slots, weighted):
    """A live-sorted flat store: sentinels spread through it, tombstones
    (w = 0), 50 empty rows and a hub row of ``hub_slots`` slots."""
    rows = rng.integers(0, n - 50, slots)
    rows[:hub_slots] = 7
    rows = np.sort(rows)
    cols = rng.integers(0, n, slots)
    sentinel = rng.random(slots) < 0.05
    rows[sentinel], cols[sentinel] = n, n
    w = (rng.random(slots) + 0.1 if weighted else np.ones(slots)).astype(np.float32)
    w[sentinel] = 0.0
    w[rng.random(slots) < 0.1] = 0.0  # tombstones
    return rows.astype(np.int32), cols.astype(np.int32), w


def _adversarial_rowid_store(rng, n, weighted):
    """A live-sorted store in K6's chunks: random rows below 100 in chunk 0,
    an all-sentinel chunk 1, row 150 over chunks 2-4 with sentinels inside
    its run, row 151 of tombstones alone across the boundary of chunk 5,
    rows 201-299 without slots across the boundary of chunks 5 and 6, the
    last live row 400, then sentinel chunks."""
    c = RK.EDGE_CHUNK
    rows = np.full(9 * c, n, np.int64)
    rows[: c - 20] = np.sort(rng.integers(0, 100, c - 20))
    rows[2 * c:5 * c] = 150
    rows[2 * c + rng.choice(3 * c, 40, replace=False)] = n
    rows[5 * c - 30:5 * c + 30] = 151
    rows[5 * c + 30:6 * c] = np.sort(rng.integers(152, 201, c - 30))
    rows[6 * c:7 * c - 50] = np.sort(rng.integers(300, 401, c - 50))
    rows[6 * c] = 300
    rows[7 * c - 51] = 400
    cols = np.where(rows < n, rng.integers(0, n, rows.size), n)
    w = (rng.random(rows.size) + 0.1 if weighted else np.ones(rows.size)).astype(np.float32)
    w[(rows >= n) | (rows == 151)] = 0.0
    return rows.astype(np.int32), cols.astype(np.int32), w


@pytest.mark.parametrize("f", [8, 32, 47, 128, 130])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("store", ["random", "adversarial"])
def test_k6_matches_plain_on_the_card(cuda, rng, f, weighted, store):
    n = 3000
    if store == "random":
        rows, cols, w = _rowid_store(rng, n, 80_000, 20_000, weighted)
    else:
        rows, cols, w = _adversarial_rowid_store(rng, n, weighted)
    t = lambda a: torch.from_numpy(a).to(cuda)
    x = t(rng.standard_normal((n, f)).astype(np.float32))
    ww = t(w) if weighted else None
    before = RK.spmm_rowid.launches
    out, *plan = RK.spmm_rowid_with_plan(t(rows), t(cols), ww, x, n)
    torch.cuda.synchronize()
    assert RK.spmm_rowid.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(plan, RK.rowid_chunk_plan(t(rows), n)))  # launch 1, bit for bit
    ref = RK.spmm_rowid_plain(t(rows), t(cols), ww, x, n)
    mass = RK.spmm_rowid_plain(t(rows), t(cols), None if ww is None else ww.abs(), x.abs(), n)
    # f32 sums in another order (atomics across chunks): 2e-4 of the terms' mass
    assert ((out - ref).abs() <= 2e-4 * mass + 1e-6).all()
    assert not out[n - 50:].any()


@pytest.mark.parametrize("store", ["random", "adversarial"])
@pytest.mark.parametrize("f", [32, 128])
def test_k6_writes_every_row_of_a_poisoned_output(cuda, rng, store, f):
    n = 3000
    rows, cols, w = (_rowid_store(rng, n, 80_000, 20_000, True) if store == "random"
                     else _adversarial_rowid_store(rng, n, True))
    rows, cols, w = (torch.from_numpy(a).to(cuda) for a in (rows, cols, w))
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    ptr = _poison((n, f), cuda)
    out = RK.spmm_rowid(rows, cols, w, x, n)
    torch.cuda.synchronize()
    assert out.data_ptr() == ptr  # the output took the poisoned block
    assert not out.isnan().any()
    ref = RK.spmm_rowid_plain(rows, cols, w, x, n)
    assert ((out - ref).abs() <= 2e-4 * RK.spmm_rowid_plain(rows, cols, w, x.abs(), n) + 1e-6).all()


def test_k7_matches_plain_on_the_card(cuda, rng):
    n = 3000
    rows, _, w = _rowid_store(rng, n, 80_000, 20_000, True)
    t = lambda a: torch.from_numpy(a).to(cuda)
    before = RK.dyn_degree.launches
    counts = RK.dyn_degree(t(rows), None, n)
    live = RK.dyn_degree(t(rows), t((w > 0).astype(np.float32)), n)
    wsum = RK.dyn_degree(t(rows), t(w), n)
    indicator = RK.dyn_degree(t(rows), t(w), n, indicator=True)
    torch.cuda.synchronize()
    assert RK.dyn_degree.launches == before + 4
    assert torch.equal(indicator, live)
    assert torch.equal(counts, RK.dyn_degree_plain(t(rows), None, n))  # counts are exact
    assert torch.equal(live, RK.dyn_degree_plain(t(rows), t((w > 0).astype(np.float32)), n))
    ref = RK.dyn_degree_plain(t(rows), t(w), n)
    assert ((wsum - ref).abs() <= 2e-4 * ref.abs() + 1e-6).all()  # w > 0: the sum is its own mass
    assert not counts[n - 50:].any()


@pytest.mark.parametrize("store,hub", [("random", 200), ("random", 4_000), ("random", 20_000), ("adversarial", 0)])
def test_k7_writes_every_row_of_a_poisoned_output_at_every_chain_length(cuda, rng, store, hub):
    """K7 into a NaN-poisoned output (its private ``out`` entry), in every
    mode, on random stores whose hub row takes 200 slots (one or two spans
    of 256), 4,000 (inside a look-back window of 32 spans) and 20,000 (more
    than a window), and on the adversarial store (rows 401 to n - 1 without a slot after
    the last live row): no NaN left, counts and indicator sums bit-equal,
    weighted sums within 2e-4, the same weighted sums bit for bit on a
    second call, the ticket back at 0."""
    n = 3000
    rows, _, w = (_rowid_store(rng, n, 80_000, hub, True) if store == "random"
                  else _adversarial_rowid_store(rng, n, True))
    rows, w = torch.from_numpy(rows).to(cuda), torch.from_numpy(w).to(cuda)
    for ww, indicator in ((None, False), (w, False), (w, True)):
        ref = RK.dyn_degree_plain(rows, torch.where(w > 0, 1.0, 0.0) if indicator else ww, n)
        outs = []
        for _ in range(2):
            den = torch.full((n,), float("nan"), device=cuda)
            before = RK.dyn_degree.launches
            RK._dyn_degree_into(rows, ww, n, indicator, den)
            torch.cuda.synchronize()
            assert RK.dyn_degree.launches == before + 1
            assert not den.isnan().any()
            outs.append(den)
        if ww is None or indicator:
            assert torch.equal(outs[0], ref) and torch.equal(outs[1], ref)
        else:
            assert ((outs[0] - ref).abs() <= 2e-4 * ref.abs() + 1e-6).all()
            assert torch.equal(outs[0], outs[1])  # a fixed order of the sums
        assert not outs[0][n - 50:].any()
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert RK._K7_STATE[(rows.device.index, stream)][1].item() == 0


@pytest.mark.parametrize("weighted", [False, True])
def test_tgcn_on_a_lazy_pair_on_cuda_matches_cpu(cuda, rng, weighted):
    """Three timesteps of updates and TGCN on the pair, backward through all
    of them: 3 K7, 3 K6 forward and 3 K6 backward a timestep."""
    n, e, d, steps = 2000, 30_000, 500, 3
    keys = rng.choice(n * n, e + steps * d, replace=False)
    src, dst = keys[:e] // n, keys[:e] % n
    w0 = (rng.random(e) + 0.1).astype(np.float32) if weighted else None
    adds = [np.stack([k // n, k % n], 1).astype(np.int32) for k in np.split(keys[e:], steps)]
    dels = [np.stack([src[i * d:(i + 1) * d], dst[i * d:(i + 1) * d]], 1).astype(np.int32) for i in range(steps)]
    aw = [(rng.random(d) + 0.1).astype(np.float32) for _ in range(steps)] if weighted else [None] * steps
    xs = [rng.standard_normal((n, 8)).astype(np.float32) for _ in range(steps)]
    ref_layer = TGCN(8, 32, device="cpu", generator=torch.Generator().manual_seed(2))
    results = []
    for dev in ("cpu", cuda):
        layer = TGCN(8, 32, device=dev)
        layer.load_state_dict(ref_layer.state_dict())
        pair = DS.lazy_pair_from_edges(src, dst, n, e + 2048, 2 * d, weights=w0, device=dev)
        t = lambda a: None if a is None else torch.from_numpy(a).to(dev)
        x = [t(v).requires_grad_() for v in xs]
        counts = RK.spmm_rowid.launches, RK.dyn_degree.launches
        h = None
        for i in range(steps):
            pair = DS.apply_delta_lazy_pair(pair, t(adds[i][:, 0]), t(adds[i][:, 1]), t(dels[i][:, 0]),
                                            t(dels[i][:, 1]), add_weights=t(aw[i]))
            h = layer(pair, x[i], hidden=h)
        (h ** 2).mean().backward()
        if dev != "cpu":
            torch.cuda.synchronize()
            assert (RK.spmm_rowid.launches - counts[0], RK.dyn_degree.launches - counts[1]) == (6 * steps, 3 * steps)
        results.append([h.detach()] + [p.grad for p in layer.parameters()] + [v.grad for v in x])
    for ref, out in zip(*results):
        _close(out.cpu(), ref, tol=1e-4)


@pytest.mark.parametrize("which", ["interior", "frontier", "local"])
@pytest.mark.parametrize("heads", [0, 1, 4])
def test_k1_shard_mode_and_k2_on_the_rectangular_transpose_match_plain_on_the_card(cuda, rng, which, heads):
    """K1's shard mode (``spmm_rowmask_traced``, f32 stream) on one shard's
    CSRs of a 3-way partition (unweighted when ``heads`` is 0; 4 heads of 32
    with the denominator), and K2 on their rectangular transposes."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_traced
    from stgraph_tpu_torch.parallel import partition_edges

    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    csr = getattr(partition_edges(src, dst, n, 3).shard(0, cuda), f"{which}_csr")
    h = max(heads, 1)
    width = 128 if heads > 1 else 47
    x = torch.from_numpy(rng.standard_normal((csr.num_cols, width)).astype(np.float32)).to(cuda)
    w = None
    if heads:
        w = torch.from_numpy(rng.random((csr.capacity, h)).astype(np.float32)).to(cuda)
        w[csr.num_edges:] = 0.0
        w = w.reshape(-1) if h == 1 else w
    before = spmm_rowmask_traced.launches, spmm_rowmask.launches
    out, den = spmm_rowmask_traced(csr, w, x, heads=h, with_denom=heads > 1)
    torch.cuda.synchronize()
    assert (spmm_rowmask_traced.launches, spmm_rowmask.launches) == (before[0] + 1, before[1])
    assert out.shape == (csr.num_nodes, width)
    absw = None if w is None else w.abs()
    if heads > 1:
        ref, ref_den = spmm_rowmask_plain(csr, w, x, torch.float32, heads=h, with_denom=True)
        _within_mass(den, ref_den, ref_den)
    else:
        ref = spmm_rowmask_plain(csr, w, x, torch.float32)
    _within_mass(out, ref, spmm_rowmask_plain(csr, absw, x.abs(), torch.float32, heads=h))
    if heads:
        csr_t = csr.transpose()
        w_t = w.index_select(0, csr.edge_perms()[0].long())
        g = torch.from_numpy(rng.standard_normal((csr.num_nodes, width)).astype(np.float32)).to(cuda)
        dh, dw = spmm_rowmask_bwd(csr_t, w_t, g, x, heads=h)
        torch.cuda.synchronize()
        ref_dh, ref_dw = spmm_rowmask_bwd_plain(csr_t, w_t, g, x, torch.float32, heads=h)
        mass_dh, mass_dw = spmm_rowmask_bwd_plain(csr_t, w_t.abs(), g.abs(), x.abs(), torch.float32, heads=h)
        _within_mass(dh, ref_dh, mass_dh)
        _within_mass(dw, ref_dw, mass_dw)


def test_dist_gcn_step_at_world_size_one_on_cuda_matches_cpu(cuda, rng):
    """``benchmarking/dist/train.py``'s step at world size 1 (a one-process
    gloo group): the kernel route on the card (K1's shard mode forward, K1
    on the transpose backward) against the plain route on the CPU, loss and
    gradients."""
    import socket

    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_traced
    from stgraph_tpu_torch.parallel import dist_spmm, launch, make_mesh, partition_edges

    n, e, dims = 3000, 60_000, (16, 32, 32, 5)
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    x = rng.standard_normal((n, dims[0])).astype(np.float32)
    y = rng.integers(0, dims[-1], n)
    norm = (rng.random((n, 1)) + 0.5).astype(np.float32)
    ws = [(rng.standard_normal((a, b)) * 0.1).astype(np.float32) for a, b in zip(dims[:-1], dims[1:])]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    launch.initialize(f"127.0.0.1:{port}", 1, 0, backend="gloo")
    try:
        mesh = make_mesh(device="cuda")
        dg = partition_edges(src, dst, n, 1)
        res = {}
        for dev, impl in ((cuda, "kernel"), (torch.device("cpu"), "torch")):
            params = [torch.from_numpy(w).to(dev).requires_grad_() for w in ws]
            h = torch.from_numpy(x).to(dev)
            nn_ = torch.from_numpy(norm).to(dev)
            before = spmm_rowmask_traced.launches, spmm_rowmask.launches
            for i, w in enumerate(params):
                h = dist_spmm(mesh, dg, (h @ w) * nn_, impl=impl) * nn_
                h = torch.relu(h) if i < len(params) - 1 else h
            loss = torch.nn.functional.cross_entropy(h, torch.from_numpy(y).to(dev))
            loss.backward()
            if impl == "kernel":
                torch.cuda.synchronize()
                assert (spmm_rowmask_traced.launches - before[0], spmm_rowmask.launches - before[1]) == (3, 3)
            res[impl] = [loss.detach().cpu()] + [w.grad.cpu() for w in params]
    finally:
        launch.shutdown()
    for got, want in zip(res["kernel"], res["torch"]):
        assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())
