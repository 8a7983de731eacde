"""The host and device plans of K10 and K6, on the CPU.

K10 walks a host-built work list over the blocked layout
(``ops.spmm_blocked.k10_work_items``): each item a slot range of one row,
at most ``K10_CHUNK`` slots, and its warps hold panels of one head's
columns (``k10_panels``), checked here by the kernel's index arithmetic.
K6 plans its chunks on the device
(``ops.rowid_kernels.rowid_chunk_plan``: each chunk's first and last row
id and a bitmap of the rows that have a slot; its plain version is here
held against a direct numpy computation). The kernels run only on the
card; here each plan is held against numpy, and a numpy walk of the
kernel's writes over the plan, into an output filled with NaN, must give
the plain version's result with every row written and each unshared row
written once.
"""

import numpy as np
import pytest
import torch

from stgraph_tpu_torch.graph.blocked import ROW_BLOCK, build_blocked
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.ops import rowid_kernels as RK
from stgraph_tpu_torch.ops import spmm_blocked as SB


def _layout(rng, n=1500, e=20_000, hub_deg=1000):
    """A blocked layout with a hub row of ``hub_deg`` edges, 40 empty rows at
    the end and an empty 128-row block (rows 512-639)."""
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 40, e)
    dst = np.where(dst // ROW_BLOCK == 4, 3, dst)  # block 4 empty
    dst[:hub_deg] = 300
    csr = build_csr(src, dst, n, capacity=e + 9, device="cpu")
    return csr, build_blocked(csr)


@pytest.mark.parametrize("chunk", [SB.K10_CHUNK, 64])
def test_k10_items_cover_every_real_slot_once_in_order(chunk):
    csr, blk = _layout(np.random.default_rng(0))
    item_row, beg, end, split = SB.k10_work_items(blk.host_indptr, blk.host_offsets, chunk)
    rows = np.where(item_row < 0, ~item_row, item_row)
    assert np.all(end >= beg) and np.all(end - beg <= chunk)
    assert np.all(np.diff(rows) >= 0)  # items in row order
    slots = np.concatenate([np.arange(b, e_) for b, e_ in zip(beg, end)])
    dst = blk.dst.numpy()
    real = np.flatnonzero(dst < csr.num_nodes)
    assert np.array_equal(slots, real)  # every real slot once, in layout order
    assert np.array_equal(dst[slots], np.repeat(rows, end - beg))  # each slot's own row
    deg = np.diff(csr.host_arrays()[0].astype(np.int64))
    assert np.array_equal(split, np.flatnonzero(deg > chunk))
    assert np.array_equal(np.unique(rows[item_row < 0]), split)  # split rows coded ~d, the others d
    assert np.array_equal(np.bincount(rows, minlength=csr.num_nodes), np.maximum(1, -(-deg // chunk)))


def test_k10_items_of_empty_rows_blocks_and_hubs():
    csr, blk = _layout(np.random.default_rng(1))
    n = csr.num_nodes
    item_row, beg, end, split = SB.k10_work_items(blk.host_indptr, blk.host_offsets)
    empty = beg == end
    # the 40 empty rows and the empty block's 128 rows each get one empty item
    for r in list(range(n - 40, n)) + list(range(4 * ROW_BLOCK, 5 * ROW_BLOCK)):
        at = np.flatnonzero(item_row == r)
        assert at.size == 1 and empty[at[0]]
    hub = np.flatnonzero(item_row == ~300)
    deg = int(blk.host_indptr[301] - blk.host_indptr[300])
    assert hub.size == -(-deg // SB.K10_CHUNK) > 1 and 300 in split  # the hub spans several items
    assert np.array_equal(beg[hub][1:], end[hub][:-1])  # contiguous
    assert (end[hub] - beg[hub]).sum() == deg
    # the layout keeps the items it builds
    assert SB._work_items(blk) is SB._work_items(blk)


def _k10_walk(blk, wb, x, heads, chunk=SB.K10_CHUNK):
    """K10's writes over its work items, in numpy: each unsplit row stored
    once, split rows zeroed and added to, into an output of NaN."""
    item_row, beg, end, split = SB.k10_work_items(blk.host_indptr, blk.host_offsets, chunk)
    n, hf = x.shape
    f = hf // heads
    out = np.full((n, hf), np.nan, np.float64)
    out[split] = 0.0
    cols = blk.cols.numpy()
    w = np.repeat(wb.numpy().astype(np.float64), f, axis=1)
    for code, b, e in zip(item_row, beg, end):
        acc = (x.numpy()[cols[b:e]] * w[b:e]).sum(0) if e > b else np.zeros(hf)
        if code < 0:
            out[~code] += acc
        else:
            out[code] = acc
    return out


@pytest.mark.parametrize("heads,f", [(4, 8), (3, 7)])
def test_k10_walk_over_items_writes_every_row_once(heads, f):
    rng = np.random.default_rng(2)
    csr, blk = _layout(rng, n=700, e=6000, hub_deg=600)
    x = torch.from_numpy(rng.standard_normal((csr.num_nodes, heads * f)).astype(np.float32))
    wb = torch.from_numpy(rng.random((blk.capacity, heads)).astype(np.float32))
    out = _k10_walk(blk, wb, x, heads)
    assert not np.isnan(out).any()
    np.testing.assert_allclose(out, SB.segment_sum_blocked_plain(blk, wb, x, heads).numpy(), rtol=1e-5, atol=1e-5)


# -- K6's chunk plan ---------------------------------------------------------

CHUNK = 8


def _adversarial_store(n=40):
    """A live-sorted store over chunks of 8 slots: row 1 empty inside chunk
    0; an all-sentinel chunk (slots 8-15); row 5 spanning three chunks with
    sentinels inside its run (slots 16-39); row 7 of tombstones alone across
    the chunk boundary at slot 48; rows 11-13 without slots across the
    boundary at slot 56; rows 16-39 after the last live slot, followed by
    two sentinel chunks."""
    rows = np.full(80, n, np.int64)
    rows[0:6] = [0, 0, 2, 2, 3, 4]
    rows[16:40] = 5
    rows[[18, 25, 33]] = n  # sentinels inside row 5's run
    rows[40:44] = 6
    rows[44:52] = 7  # tombstones only (w = 0)
    rows[52:56] = [9, 9, 10, 10]
    rows[56:60] = [14, 14, 15, 15]
    live = (rows < n) & (rows != 7)
    w = np.zeros(80, np.float32)
    w[live] = np.linspace(0.5, 1.5, live.sum())
    cols = np.where(rows < n, np.arange(80) % n, n)
    return rows.astype(np.int32), cols.astype(np.int32), w, n


def _plan_numpy(rows, n, chunk):
    first, last = [], []
    for c0 in range(0, len(rows), chunk):
        r = rows[c0:c0 + chunk]
        r = r[r < n]
        first.append(int(r.min()) if r.size else -1)
        last.append(int(r.max()) if r.size else -1)
    has = np.zeros(-(-n // 32) * 32, bool)
    has[rows[rows < n]] = True
    present = np.packbits(has.reshape(-1, 32)[:, ::-1], axis=1).view(">u4").reshape(-1).astype(np.uint32)
    return np.array(first, np.int32), np.array(last, np.int32), present.view(np.int32)


def test_rowid_chunk_plan_matches_numpy_on_adversarial_store():
    rows, _, _, n = _adversarial_store()
    first, last, present = RK.rowid_chunk_plan(torch.from_numpy(rows), n, CHUNK)
    ref_first, ref_last, ref_present = _plan_numpy(rows, n, CHUNK)
    assert first.dtype == last.dtype == present.dtype == torch.int32
    assert np.array_equal(first.numpy(), ref_first) and np.array_equal(last.numpy(), ref_last)
    assert np.array_equal(present.numpy(), ref_present)
    bits = (present.numpy().view(np.uint32)[:, None] >> np.arange(32)) & 1
    assert list(np.flatnonzero(bits.reshape(-1))) == [0, 2, 3, 4, 5, 6, 7, 9, 10, 14, 15]
    assert ref_first[1] == -1 and ref_last[1] == -1  # the all-sentinel chunk
    assert list(ref_first[2:5]) == [5, 5, 5] and list(ref_last[2:5]) == [5, 5, 5]  # row 5 over three chunks
    assert (ref_last[5], ref_first[6]) == (7, 7)  # the tombstone-only row on both sides of a boundary
    assert (ref_last[6], ref_first[7]) == (10, 14)  # empty rows across a boundary
    assert list(ref_first[8:]) == [-1, -1]  # after the last live slot


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rowid_chunk_plan_matches_numpy_on_random_stores(seed):
    rng = np.random.default_rng(seed)
    n, cap = 300, 2000 + seed  # a ragged last chunk
    rows = np.sort(rng.integers(0, n - 30, cap))
    rows[rng.random(cap) < 0.3] = n
    rows[1200:1400] = n  # a run of all-sentinel chunks
    for chunk in (CHUNK, RK.EDGE_CHUNK):
        plan = RK.rowid_chunk_plan(torch.from_numpy(rows.astype(np.int32)), n, chunk)
        for got, ref in zip(plan, _plan_numpy(rows, n, chunk)):
            assert np.array_equal(got.numpy(), ref)


def _k6_walk(rows, cols, w, x, n, chunk):
    """K6's writes over its chunk plan, in numpy, into an output of NaN:
    launch 1 zeroes each chunk's first and last row; launch 2 stores the
    runs of a chunk's inner rows, adds the runs of its first and last rows,
    and stores zeros in the rows whose bit the plan's bitmap lacks."""
    first, last, present = (t.numpy() for t in RK.rowid_chunk_plan(torch.from_numpy(rows), n, chunk))
    out = np.full((n, x.shape[1]), np.nan, np.float64)
    for c in range(len(first)):
        for r in (first[c], last[c]):
            if r >= 0:
                out[r] = 0.0
    writes = np.zeros(n, np.int64)  # plain stores a row gets
    has = ((present.view(np.uint32)[:, None] >> np.arange(32)) & 1).reshape(-1)[:n].astype(bool)
    out[~has] = 0.0
    writes[~has] += 1
    for c in range(len(first)):
        cur, acc = -1, np.zeros(x.shape[1])

        def flush():
            if cur < 0:
                return
            if cur in (first[c], last[c]):
                out[cur] += acc
            else:
                out[cur] = acc
                writes[cur] += 1

        for e in range(c * chunk, min((c + 1) * chunk, len(rows))):
            r = rows[e]
            if r >= n:
                continue
            if r != cur:
                flush()
                cur, acc = r, np.zeros(x.shape[1])
            if w[e] != 0:
                acc = acc + np.float64(np.float32(x[cols[e]] * w[e]))
        flush()
    return out, writes


@pytest.mark.parametrize("store", ["adversarial", "random"])
def test_k6_walk_over_the_plan_writes_every_row_once(store):
    if store == "adversarial":
        rows, cols, w, n = _adversarial_store()
        chunk = CHUNK
    else:
        rng = np.random.default_rng(3)
        n, cap = 400, 3000
        rows = np.sort(rng.integers(0, n - 60, cap))
        rows[:300] = 17  # a hub over many chunks
        rows = np.sort(rows)
        rows[rng.random(cap) < 0.1] = n
        rows = rows.astype(np.int32)
        cols = np.where(rows < n, rng.integers(0, n, cap), n).astype(np.int32)
        w = np.where((rows < n) & (rng.random(cap) > 0.1), rng.random(cap) + 0.1, 0.0).astype(np.float32)
        chunk = 16
    x = np.random.default_rng(4).standard_normal((n, 5)).astype(np.float32)
    out, writes = _k6_walk(rows, cols, w, x, n, chunk)
    assert not np.isnan(out).any()
    first, last, _ = RK.rowid_chunk_plan(torch.from_numpy(rows), n, chunk)
    shared = np.unique(np.concatenate([first.numpy(), last.numpy()]))
    shared = shared[shared >= 0]
    assert np.all(writes[shared] == 0) and np.all(np.delete(writes, shared) == 1)  # each other row stored once
    ref = RK.spmm_rowid_plain(*(torch.from_numpy(a) for a in (rows, cols, w, x)), n)
    np.testing.assert_allclose(out, ref.numpy(), rtol=1e-5, atol=1e-6)


def test_spmm_rowid_with_plan_on_the_cpu_returns_the_plain_plan():
    rows, cols, w, n = _adversarial_store()
    t = [torch.from_numpy(a) for a in (rows, cols, w)]
    x = torch.randn(n, 3)
    out, *plan = RK.spmm_rowid_with_plan(*t, x, n)
    assert torch.equal(out, RK.spmm_rowid_plain(*t, x, n))
    assert all(torch.equal(a, b) for a, b in zip(plan, RK.rowid_chunk_plan(t[0], n)))
    assert torch.equal(RK.spmm_rowid(*t, x, n), out)


@pytest.mark.parametrize("heads,f,align,expected", [
    (4, 256, 16, (4, 1, 2)), (6, 121, 16, (2, 2, 1)), (6, 47, 16, (2, 1, 1)), (3, 20, 16, (4, 1, 1)),
    (40, 4, 16, (4, 1, 1)), (17, 8, 16, (4, 1, 1)), (3, 7, 16, (1, 1, 1)), (4, 256, 4, (1, 4, 2)),
])
def test_k10_panels_cover_each_heads_columns_once_with_aligned_loads(heads, f, align, expected):
    """The columns K10's lanes keep, by the kernel's own arithmetic over the
    grid ``(item, heads * per_head)``: each column of the row once, in its
    own head's panel, every load ``v`` columns aligned to ``v`` inside the
    row."""
    hf = heads * f
    v, pieces, per_head = SB.k10_panels(f, hf, align)
    assert (v, pieces, per_head) == expected
    assert pieces * 32 * v <= max(SB.K10_PANEL, 32 * v) and align % (4 * v) == 0 and hf % v == 0
    kept = np.zeros(hf, np.int64)
    for y in range(heads * per_head):
        head = y // per_head
        c_beg, c_end = head * f, head * f + f
        for lane in range(32):
            for p in range(pieces):
                c = c_beg // v * v + (y % per_head) * pieces * 32 * v + lane * v + p * 32 * v
                if not (c < c_end and c + v > c_beg):
                    continue  # a piece outside the head loads nothing
                assert c % v == 0 and c + v <= hf
                kept[[k for k in range(c, c + v) if c_beg <= k < c_end]] += 1
    assert np.all(kept == 1)
