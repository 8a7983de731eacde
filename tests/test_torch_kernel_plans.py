"""The host and device plans of K10, K6, K1, K8 and K9, on the CPU.

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
written once. K1, K8 and K9 cover a gathered row with groups of lanes
(``spmm_kernels.k1_lanes``, ``flash_gat.flash_lanes``), checked by their
index arithmetic; K8's and K9's walk (rounds, one weight pair a lane, the
groups' meeting, the stores) runs here in numpy against their plain
versions.
"""

import numpy as np
import pytest
import torch

from stgraph_tpu_torch.graph.blocked import ROW_BLOCK, build_blocked
from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.ops import rowid_kernels as RK
from stgraph_tpu_torch.ops import spmm_blocked as SB
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)


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


# -- K1: lane groups, aligned-down loads, item lengths, the packed bf16 product --


def _k1_walk_columns(f, ld, elem, offset, heads=1, rows=8):
    """The tile columns each lane of K1 keeps, by the kernel's own index
    arithmetic (``csrc/spmm_rowmask.cu``), for the gathered rows 0..rows-1 of
    a table ``offset`` bytes past a 16 B boundary with row stride ``ld``.
    Checks every load on the way; returns, per row, the count of times each
    of the row's ``f`` columns is kept and stored."""
    from stgraph_tpu_torch.ops.spmm_kernels import k1_lanes

    v = 16 // elem
    aligned = ld % v == 0 and offset % 16 == 0
    g, tile = k1_lanes(f, elem, aligned)
    assert g & (g - 1) == 0 and 1 <= g <= 32
    head_f = f // heads
    kept = np.zeros((rows, f), np.int64)
    for src in range(rows):
        for y in range(-(-f // tile)):
            c0 = y * tile
            tw = min(tile, f - c0)
            a = offset + (src * ld + c0) * elem  # the tile's first byte
            if aligned:
                for sub in range(g):
                    col = sub * v
                    if col >= tw:
                        continue  # an idle lane loads nothing
                    start = a + col * elem
                    assert start % 16 == 0 and start + 16 <= offset + (src + 1) * ld * elem  # inside the row
                    if heads > 1:
                        nh = max(1, v // head_f)
                        head0 = (c0 + col) // head_f
                        assert head0 % nh == 0 and heads % nh == 0  # the weight vector is aligned
                        for k in range(v):
                            assert head0 + k * nh // v == (c0 + col + k) // head_f  # the column's own head
                    for k in range(v):
                        if col + k < tw:
                            kept[src, c0 + col + k] += 1
            else:
                assert elem == 4 and heads == 1
                s = (a >> 2) & 3
                a0 = a - 4 * s
                slots = {}  # (lane, slot) -> tile column, after the hand-over to the lane before
                for sub in range(g):
                    if 4 * sub >= s + tw:
                        continue
                    start = a0 + 16 * sub
                    assert start % 16 == 0
                    assert start < a + tw * elem and start + 16 > a  # the 16 B hold a column of the tile
                    for k in range(4):
                        r = (k + s) & 3  # the kernel's rotation
                        pos = 4 * sub + r  # the position loaded, from a0
                        col = pos - s
                        owner = sub if k + s < 4 else sub - 1
                        assert col == 4 * owner + k
                        slots[(owner, k)] = col
                assert max(sub for sub in range(g) if 4 * sub < s + tw) < g
                for sub in range(g):
                    for k in range(4):
                        if 4 * sub + k < tw:  # the lane stores this slot
                            kept[src, c0 + slots[(sub, k)]] += 1
    return g, tile, kept


@pytest.mark.parametrize("f,ld,elem,offset,heads,g", [
    (128, 128, 2, 0, 1, 16),  # one head, bf16: 2 edges a step
    (47, 48, 2, 0, 1, 8),  # bf16 at F = 47, the stride padded to 48: 4 edges a step
    (48, 48, 2, 0, 1, 8),
    (64, 64, 4, 0, 1, 16),  # the shard mode at F = 64, f32: 2 edges a step
    (47, 47, 4, 0, 1, 16),  # the shard mode at F = 47: aligned-down loads
    (47, 47, 4, 4, 1, 16),
    (64, 64, 4, 12, 1, 32),  # a table 12 B off: aligned-down loads over 67 columns
    (200, 200, 4, 4, 1, 32),  # two tiles of 124 and 76 columns
    (300, 304, 2, 0, 1, 32),  # bf16, two tiles of 256 and 44 columns
    (128, 128, 4, 0, 4, 32),  # 4 x 32 heads, f32
    (128, 128, 2, 0, 4, 16),  # 4 x 32 heads, bf16
    (128, 128, 4, 0, 32, 32),  # 32 x 4, f32: a lane's 4 columns one head
    (128, 128, 2, 0, 32, 16),  # 32 x 4, bf16: a lane's 8 columns two heads
    (128, 128, 2, 0, 128, 16),  # 128 x 1, bf16: eight heads a lane
])
def test_k1_lane_groups_keep_each_column_once_with_aligned_loads(f, ld, elem, offset, heads, g):
    got_g, tile, kept = _k1_walk_columns(f, ld, elem, offset, heads)
    assert got_g == g
    assert np.all(kept == 1)


def test_k1_lanes_refuse_unaligned_bf16_rows():
    from stgraph_tpu_torch.ops.spmm_kernels import k1_lanes

    with pytest.raises(ValueError):
        k1_lanes(47, 2, aligned=False)
    assert k1_lanes(125, 4, aligned=False) == (32, 125)  # 128 positions at most from the aligned start
    assert k1_lanes(126, 4, aligned=False) == (32, 124)


def test_k1_item_lengths_by_mode():
    """K1 takes its own item length by mode, each length's items cached
    apart; each item holds at most its length."""
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    assert set(SK.K1_CHUNK) == {"one_head", "heads", "nogather"}
    assert all(c in (128, 256, 512, 1024) for c in SK.K1_CHUNK.values())
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 500, 9000), rng.integers(0, 490, 9000)
    dst[:3000] = 4  # a hub
    csr = build_csr(src, dst, 500, device="cpu")
    indptr = csr.host_arrays()[0].astype(np.int64)
    items = {c: SK._work_items(csr, c) for c in (128, 256, 1024)}
    for c, (row, beg, split) in items.items():
        assert SK._work_items(csr, c) is items[c]  # built once a length
        row, beg = row.numpy(), beg.numpy().astype(np.int64)
        end = np.minimum(beg + c, indptr[1:][row])
        assert np.all(end - beg <= c) and np.array_equal(split.numpy(), np.flatnonzero(np.diff(indptr) > c))
        assert np.array_equal(np.concatenate([np.arange(b, e) for b, e in zip(beg, end)]), np.arange(indptr[-1]))


def _work_item_calls(path):
    import ast

    calls = {}
    for fn in ast.walk(ast.parse(open(path).read())):
        if isinstance(fn, ast.FunctionDef):
            for c in ast.walk(fn):
                if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute) and c.func.attr.startswith("stg_"):
                    calls.setdefault(fn.name, []).append(("entry", [ast.unparse(a) for a in c.args]))
                if isinstance(c, ast.Call) and getattr(c.func, "id", None) == "_work_items":
                    calls.setdefault(fn.name, []).append(("items", [ast.unparse(a) for a in c.args]
                                                          + [ast.unparse(k) for k in c.keywords]))
    return calls


def test_every_kernel_takes_its_own_item_length():
    """``_work_items`` has no default length (the first designs' ROW_CHUNK
    is no kernel's): K1's wrappers pass a length of their own (K1_CHUNK),
    K2's theirs (K2_CHUNK by mode), K4 its own (K4_CHUNK, with 16 lanes an
    item) and K8's and K9's theirs (FLASH_CHUNK "fwd" and "bwd"), the same
    length to ``_work_items`` and to the kernel; K5 builds its own items
    (``_k5_plan``, one int4 an item) at K5_CHUNK, and K3 its own
    (``_k3_plan``, K5's items with scratch slots) at K3_CHUNK, which it
    passes to its plan and to its entry. The measured lengths are pinned
    here."""
    import ast
    import inspect
    import os

    from stgraph_tpu_torch.ops import segment_kernels as SEG
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    assert SK.ROW_CHUNK == 1024
    assert inspect.signature(SK._work_items).parameters["chunk"].default is inspect.Parameter.empty
    assert set(SK.FLASH_CHUNK) == {"fwd", "bwd"}
    assert all(c in (128, 256, 512, 1024) for c in SK.FLASH_CHUNK.values())
    assert SK.K2_CHUNK == {"one_head": 512, "heads": 128}
    assert SEG.K4_CHUNK == 1024
    assert SEG.K5_CHUNK == 128
    assert SEG.K3_CHUNK == 256
    ops = os.path.join(os.path.dirname(SK.__file__))
    calls = {}
    for name in ("segment_kernels.py", "spmm_kernels.py", "flash_gat.py"):
        calls.update(_work_item_calls(os.path.join(ops, name)))
    for fn in ("segment_sum_narrow", "segment_max_wide"):  # K3, K5: their own items, not _work_items
        assert "items" not in dict(calls[fn]), fn
    kinds = dict(calls["segment_sum_narrow"])
    assert "chunk" in kinds["entry"] and "ROW_CHUNK" not in kinds["entry"], kinds
    # K1, its no-gather mode, K2, K4, K8, K9
    for fn in ("_launch_k1", "segment_sum_wide", "spmm_rowmask_bwd", "segment_max_narrow", "flash_gat_fwd",
               "flash_gat_bwd"):
        kinds = dict(calls[fn])
        assert kinds["items"][1] == "chunk" and "chunk" in kinds["entry"] and "ROW_CHUNK" not in kinds["entry"]
    chunks = {}
    for name in ("spmm_kernels.py", "segment_kernels.py", "flash_gat.py"):
        tree = ast.parse(open(os.path.join(ops, name)).read())
        for d in tree.body:
            if isinstance(d, ast.FunctionDef):
                chunks[d.name] = [ast.unparse(a.value) for a in ast.walk(d)
                                  if isinstance(a, ast.Assign) and [ast.unparse(t) for t in a.targets] == ["chunk"]]
    assert chunks["flash_gat_fwd"] == ["FLASH_CHUNK['fwd']"] and chunks["flash_gat_bwd"] == ["FLASH_CHUNK['bwd']"]
    assert chunks["spmm_rowmask_bwd"] == ["K2_CHUNK['heads' if heads > 1 else 'one_head']"]
    assert chunks["segment_max_narrow"] == ["K4_CHUNK"]
    assert chunks["segment_max_wide"] == ["K5_CHUNK"]
    assert chunks["segment_sum_narrow"] == ["K3_CHUNK"]
    tree = ast.parse(open(os.path.join(ops, "segment_kernels.py")).read())
    k5 = next(d for d in tree.body if isinstance(d, ast.FunctionDef) and d.name == "segment_max_wide")
    plans = [ast.unparse(c) for c in ast.walk(k5) if isinstance(c, ast.Call) and getattr(c.func, "id", "") == "_k5_plan"]
    assert plans == ["_k5_plan(csr, chunk, k)"]
    k3 = next(d for d in tree.body if isinstance(d, ast.FunctionDef) and d.name == "segment_sum_narrow")
    plans = [ast.unparse(c) for c in ast.walk(k3) if isinstance(c, ast.Call) and getattr(c.func, "id", "") == "_k3_plan"]
    assert plans == ["_k3_plan(csr, chunk, k)"]


def _bf16_bits_rne(x32):
    """f32 -> bf16 bits, round to nearest even (NaN not expected)."""
    u = x32.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint32) & 0xFFFF


def _bf16_of_exact(p):
    """bf16 bits of the f64 value ``p`` rounded once, to nearest even, with
    bf16's subnormals and overflow to infinity; computed without f32."""
    a = np.abs(p)
    _, ex = np.frexp(a)
    q = np.ldexp(1.0, np.maximum(ex - 1, -126) - 7)  # the bf16 quantum at a's binade
    r = np.rint(a / q) * q
    r = np.where(r >= 2.0**128, np.inf, r)
    bits = (r.astype(np.float32).view(np.uint32) >> 16).astype(np.uint32)
    return bits | np.where(np.signbit(p), 0x8000, 0).astype(np.uint32)


def test_packed_bf16_product_is_the_first_designs_formula():
    """The identity K1's bf16 path rests on: the exact product of two bf16
    values rounded once to bf16 (one ``mul.rn.bf16x2``) equals the first
    design's ``round_to_bf16(__fmul_rn(x, w))``, on a sample of pairs and on
    the subnormal, overflowing and signed-zero edge cases. The card holds the
    two bit for bit over all 2^32 pairs (``stg_bf16_product_check``)."""
    rng = np.random.default_rng(11)
    edge = np.array([0x0000, 0x8000, 0x0001, 0x8001, 0x007F, 0x0080, 0x0081, 0x00FF, 0x3F80, 0xBF80,
                     0x3F81, 0x4000, 0x7F7F, 0xFF7F, 0x7F00, 0x7E80, 0x0100, 0x1F80, 0x2000, 0x5F80,
                     0x6000, 0x3C00, 0x4300, 0x7F80, 0xFF80], np.uint32)
    sample = rng.integers(0, 1 << 16, (2, 1 << 20), dtype=np.uint32)
    tiny = rng.integers(0, 1 << 16, 1 << 16, dtype=np.uint32) & 0x80FF  # exponents near the subnormals
    x = np.concatenate([np.repeat(edge, edge.size), sample[0], tiny, tiny])
    w = np.concatenate([np.tile(edge, edge.size), sample[1], np.roll(tiny, 7), rng.permutation(edge.repeat(3000))[
        :tiny.size] | 0x3000])
    xf = (x << 16).view(np.float32)
    wf = (w << 16).view(np.float32)
    with np.errstate(over="ignore", invalid="ignore", under="ignore"):
        formula = _bf16_bits_rne((xf * wf).astype(np.float32))
        exact = xf.astype(np.float64) * wf.astype(np.float64)  # exact: 8-bit significands
        keep = ~np.isnan(exact)
        single = _bf16_of_exact(exact[keep])
    assert np.array_equal(formula[keep], single)
    subnormal = (single & 0x7F80) == 0
    assert subnormal.sum() > 1000 and (single == 0x7F80).any() and (single == 0x8000).any()


# -- K8 and K9: lane groups, rounds and weight pairs, item lengths --------


def _flash_geometry(h, f, elem):
    """K8's and K9's walk (``csrc/flash_gat_walk.cuh``) at ``h`` x ``f``:
    its lanes a row, loads a lane, edges a step, steps and edges a round,
    KH, weight passes a round, and the padded row stride."""
    from stgraph_tpu_torch.ops.flash_gat import flash_lanes

    g, loads = flash_lanes(h * f, elem)
    v = 16 // elem
    eps = 32 // g
    steps = 4 if eps * 4 <= 32 else 32 // eps
    log_kh = (h - 1).bit_length()
    kh = 1 << log_kh
    rnd = steps * eps
    return dict(g=g, loads=loads, v=v, kc=v * loads, eps=eps, steps=steps, rnd=rnd, log_kh=log_kh, kh=kh,
                passes=(rnd * kh + 31) >> 5, ld=-(-(h * f) // v) * v)


def test_flash_lanes_cover_each_row_once_at_every_tiling():
    """At every tiling ``flash_supported`` takes and both streams: ``g`` is
    the fewest lanes (a power of two) whose 16 B loads cover the row, two
    loads a lane only for an f32 row past 128 columns; each column is kept
    by one lane, every load lies inside the padded row, a round's edges
    (at most 32) fall one to a lane of the cols load, its (edge, head)
    pairs one to a (lane, pass), and a warp's ring of three rounds fits a
    block's shared memory."""
    from stgraph_tpu_torch.ops.flash_gat import FLASH_MAX_HEADS, FLASH_MAX_WIDTH, flash_supported

    tilings = [(h, f) for h in range(1, FLASH_MAX_HEADS + 1) for f in range(1, FLASH_MAX_WIDTH + 1)
               if flash_supported(h, f)]
    assert len(tilings) == sum(FLASH_MAX_WIDTH // h for h in range(1, FLASH_MAX_HEADS + 1))
    assert not flash_supported(17, 1) and not flash_supported(1, 257) and not flash_supported(2, 129)
    for h, f in tilings:
        hf = h * f
        for elem in (2, 4):
            geo = _flash_geometry(h, f, elem)
            g, loads, v, kc = geo["g"], geo["loads"], geo["v"], geo["kc"]
            assert g & (g - 1) == 0 and 1 <= g <= 32 and loads == (2 if elem == 4 and hf > 128 else 1)
            assert g * kc >= hf and (g == 1 or g // 2 * kc < hf), (h, f, elem, g)
            kept = np.zeros(hf, np.int64)
            for sub in range(g):
                for lo in range(loads):
                    start = sub * kc + lo * v
                    if start < hf:
                        assert start % v == 0 and start + v <= geo["ld"]
                        kept[start:min(start + v, hf)] += 1
            assert np.all(kept == 1), (h, f, elem)
            assert 32 % geo["rnd"] == 0 and geo["rnd"] % geo["eps"] == 0
            pairs = np.zeros((geo["rnd"], geo["kh"]), np.int64)
            for t in range(geo["passes"]):
                for lane in range(32):
                    e = (lane >> geo["log_kh"]) + t * (32 >> geo["log_kh"])
                    if e < geo["rnd"]:
                        pairs[e, lane & (geo["kh"] - 1)] += 1
            assert np.all(pairs == 1), (h, f, elem)
            ring = 3 * (geo["rnd"] * geo["kh"] * 16 + geo["rnd"] * 4)  # K9's, the larger
            assert ring <= 227 * 1024, (h, f, elem, ring)


@pytest.mark.parametrize("h,f,elem,expected", [
    (8, 32, 2, (32, 1)),  # the ogbn GAT's first layer, bf16: one edge a step
    (1, 47, 2, (8, 1)),  # its output layer: 96 B rows, four edges a step
    (8, 8, 4, (16, 1)),  # Pubmed's first layer, f32: two edges a step
    (1, 3, 4, (1, 1)),  # Pubmed's output layer: 32 edges a step
    (4, 32, 2, (16, 1)),  # dist_gat_attention's tiling
    (8, 32, 4, (32, 2)),  # an f32 row past 128 columns: two loads a lane
    (1, 47, 4, (16, 1)),
])
def test_flash_lanes_at_the_main_tilings(h, f, elem, expected):
    from stgraph_tpu_torch.ops.flash_gat import flash_lanes

    assert flash_lanes(h * f, elem) == expected


def _flash_walk(csr, h, f, elem, chunk, slope, el, er, m, fs, kind, gu=None, c=None):
    """K8 (``kind`` "fwd": out, den, u, p) or K9 ("bwd": dfs, dl) by the
    kernels' own index arithmetic (``csrc/flash_gat_walk.cuh``,
    ``flash_gat_fwd.cu``, ``flash_gat_bwd.cu``) in f64 without the bf16
    roundings: items of ``chunk`` edges walked in rounds, each round's pair
    fields and node ids copied into its stage of the ring, its row pieces
    gathered a piece a lane, its (edge, head) pairs one to a (lane, pass),
    the products, the groups' meeting and each lane's stores. Checks each
    gather (inside the row, one lane a piece) and each pair slot (written
    once, read after) on the way, and counts each output element's
    stores."""
    from stgraph_tpu_torch.ops.spmm_kernels import k1_work_items

    geo = _flash_geometry(h, f, elem)
    g, v, kc, eps, rnd, kh, ld = geo["g"], geo["v"], geo["kc"], geo["eps"], geo["rnd"], geo["kh"], geo["ld"]
    loads, steps = geo["loads"], geo["steps"]
    hf = h * f
    one_head = h == 1 or f % kc == 0
    indptr, _, cols, _ = csr.host_arrays()
    n = csr.num_nodes
    el, er, m, fs = (t.double().numpy() for t in (el, er, m, fs))
    table = np.zeros((csr.num_cols, ld))
    table[:, :hf] = (fs if kind == "fwd" else gu.double().numpy())
    c = None if c is None else c.double().numpy()
    lanes = np.arange(32)
    grp, col0 = lanes // g, (lanes % g) * kc
    hs = np.minimum(col0[:, None] + np.arange(kc), hf - 1) // f
    if one_head:
        hs = np.repeat(hs[:, :1], kc, 1)
    wh, we = lanes & (kh - 1), lanes >> geo["log_kh"]
    outs = [np.zeros((n, hf)), np.zeros((n, h)), np.zeros((n, hf)), np.zeros((n, h))]
    stores = np.zeros((n, hf), np.int64)
    item_row, item_beg, split_rows = k1_work_items(indptr, chunk)
    for row, beg in zip(item_row, item_beg):
        row_end = int(indptr[row + 1])
        nedges = min(int(beg) + chunk, row_end) - int(beg)
        split = row_end - int(indptr[row]) > chunk
        acc, acc2 = np.zeros((32, kc)), np.zeros((32, kc))
        wsum, wsum2 = np.zeros(32), np.zeros(32)  # K8: den, p; K9: cterm
        if kind == "bwd":
            xw = np.where(col0[:, None] + np.arange(kc) < hf,
                          np.concatenate([fs[row], np.zeros(ld + kc)])[col0[:, None] + np.arange(kc)], 0.0)
        for r in range(-(-nedges // rnd)):
            cnt = min(rnd, nedges - r * rnd)
            my = np.zeros(32, np.int64)
            my[:min(rnd, cnt)] = cols[int(beg) + r * rnd:int(beg) + r * rnd + min(rnd, cnt)]
            pieces, slots = {}, {}  # the round: its gathered pieces by (step, lane, load), its pair slots by (edge, head)
            for s in range(steps):  # the gathers: one 16 B piece a lane a load
                e = s * eps + grp
                for lane in np.flatnonzero(e < cnt):
                    for lo in range(loads):
                        start = col0[lane] + lo * v
                        if start < hf:
                            assert start + v <= ld
                            key = (s * 32 + lane) * loads + lo
                            assert key not in pieces and key < steps * 32 * loads
                            pieces[key] = table[my[e[lane]], start:start + v]
            for t in range(geo["passes"]):  # the ring: the pairs' node fields
                e = we + t * (32 >> geo["log_kh"])
                for lane in np.flatnonzero((wh < h) & (e < rnd) & (e < cnt)):
                    key = (int(e[lane]), int(wh[lane]))
                    assert key not in slots
                    slots[key] = int(my[e[lane] & 31])  # the node whose fields land there
            assert len(slots) == cnt * h
            w_of = {}
            for (e, hh), o in slots.items():  # the weights, from the landed fields
                if kind == "fwd":
                    s0, mm = el[o, hh] + er[row, hh], m[row, hh]
                else:
                    s0, mm = el[row, hh] + er[o, hh], m[o, hh]
                lp = 1.0 if s0 >= 0 else slope
                w = np.exp(min(s0 * lp - mm, 0.0))
                w_of[(e, hh)] = (w, w * lp)
                lane = e % (32 >> geo["log_kh"]) * kh + hh  # the lane that formed it
                assert we[lane] + (e // (32 >> geo["log_kh"])) * (32 >> geo["log_kh"]) == e and wh[lane] == hh
                if kind == "fwd":
                    wsum[lane] += w
                    wsum2[lane] += w * lp
                else:
                    wsum[lane] += w * lp * c[o, hh]
            for s in range(steps):  # the products, from the stage
                e = s * eps + grp
                for lane in np.flatnonzero((e < cnt) & (col0 < hf)):
                    x = np.concatenate([pieces.get((s * 32 + lane) * loads + lo, np.full(v, np.nan))
                                        for lo in range(loads)])
                    x = np.where(col0[lane] + np.arange(kc) < hf, x, 0.0)
                    wv = np.array([w_of[(int(e[lane]), int(hh))] for hh in hs[lane]])
                    acc[lane] += x * wv[:, 0]
                    acc2[lane] += (x * wv[:, 1]) if kind == "fwd" else wv[:, 1] * xw[lane] * x
        tot = [a.reshape(eps, g, kc).sum(0) for a in (acc, acc2)]  # the groups meet in lanes 0 .. g-1
        heads = [wsum[wh == hh].sum() for hh in range(h)], [wsum2[wh == hh].sum() for hh in range(h)]
        for sub in range(g):
            for k in range(kc):
                col = col0[sub] + k
                if col >= hf:
                    continue
                stores[row, col] += 1
                if kind == "fwd":
                    num = tot[0][sub, k] if split else tot[0][sub, k] / max(heads[0][col // f], 1e-38)
                    outs[0][row, col] += num
                    outs[2][row, col] += tot[1][sub, k]
                else:
                    outs[0][row, col] += tot[0][sub, k]
                    outs[1][row, col // f] += tot[1][sub, k]
        for hh in range(h):
            if kind == "fwd":
                outs[1][row, hh] += heads[0][hh]
                outs[3][row, hh] += heads[1][hh]
            else:
                outs[1][row, hh] -= heads[0][hh]
    if kind == "fwd":
        for r in split_rows:
            outs[0][r] /= np.maximum(np.repeat(outs[1][r], f), 1e-38)
    deg = np.diff(indptr)
    assert np.all(stores[deg <= chunk] == 1)  # every unsplit row stored once
    assert np.all(stores[deg > chunk] == -(-deg[deg > chunk] // chunk)[:, None])
    return outs if kind == "fwd" else outs[:2]


@pytest.mark.parametrize("h,f,elem", [
    (8, 32, 2), (1, 47, 2), (8, 8, 4), (1, 3, 4), (4, 32, 2), (8, 32, 4),  # the main tilings
    (3, 5, 4), (3, 5, 2), (2, 100, 2),  # a lane's columns span several heads
    (16, 1, 2), (16, 16, 4), (5, 7, 4),  # 16 weight passes a round; two loads a lane; H not a power of two
])
@pytest.mark.parametrize("chunk", [40, 7])
def test_flash_walk_matches_plain(h, f, elem, chunk):
    """K8 and K9 by their walk's index arithmetic (``_flash_walk``) against
    their plain versions (f32 stream) on a graph with empty rows and a hub
    in each direction split into items of ``chunk`` edges (7 ends items
    inside a group's edge step at every width), to 1e-5 relative."""
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_bwd_plain, flash_gat_fwd_plain, stability_max

    rng = np.random.default_rng(h * 1000 + f)
    n = 48
    src, dst = rng.integers(0, n - 5, 260), rng.integers(0, n - 5, 260)
    dst[:70] = 3
    src[-50:] = 7
    csr = build_csr(src, dst, n, device="cpu")
    csr_t = csr.transpose()
    el, er, c = (torch.from_numpy(rng.standard_normal((n, h)).astype(np.float32)) for _ in range(3))
    fs, gu = (torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)) for _ in range(2))
    m = stability_max(csr, el, er, 0.2)
    got = _flash_walk(csr, h, f, elem, chunk, 0.2, el, er, m, fs, "fwd")
    ref = flash_gat_fwd_plain(csr, el, er, m, fs, h, 0.2, torch.float32, aux=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.double().numpy(), rtol=1e-5, atol=1e-6)
    got = _flash_walk(csr_t, h, f, elem, chunk, 0.2, el, er, m, fs, "bwd", gu=gu, c=c)
    ref = flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, 0.2, torch.float32)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b.double().numpy(), rtol=1e-5, atol=1e-5)


# -- K2: lane groups, the dw fold, items; K4: lanes an item, its meeting ------


def _log2(x):
    return int(x).bit_length() - 1


def _k2_geometry(f, elem, aligned=True):
    """K2's walk (``csrc/spmm_sddmm_rowmask.cu``) for a row of ``f``
    columns: K1's lane groups and tile, edges a step, steps and edges a
    round, and the shift of the dw fold."""
    from stgraph_tpu_torch.ops.spmm_kernels import k1_lanes

    g, tile = k1_lanes(f, elem, aligned)
    eps = 32 // g
    steps = 4 if eps * 4 <= 32 else 32 // eps
    return dict(g=g, tile=tile, v=16 // elem, eps=eps, steps=steps, rnd=steps * eps,
                fold_shift=_log2(g) - _log2(steps))


@pytest.mark.parametrize("elem", [2, 4])
def test_k2_lane_groups_and_tiles_keep_each_column_once_at_every_width(elem):
    """At every width from 1 to 256 in both streams (bf16 rows padded to 8
    columns; f32 rows on their own stride, aligned-down loads where it is
    not a multiple of 4): each column is kept and stored by one lane of
    one tile, every load inside its row; a round's steps fit the group's
    lanes (the dw fold needs a lane a step), and the fold's hand-over
    reads each edge of a round from one lane of the edge's group that
    holds that step's dot."""
    for f in range(1, 257):
        ld = -(-f // 8) * 8 if elem == 2 else f
        g, tile, kept = _k1_walk_columns(f, ld, elem, 0)
        assert np.all(kept == 1), (f, elem)
        geo = _k2_geometry(f, elem, ld % (16 // elem) == 0)
        assert (geo["g"], geo["tile"]) == (g, tile)
        assert geo["steps"] <= g and 32 % geo["rnd"] == 0 and geo["fold_shift"] >= 0
        for t in range(geo["rnd"]):
            lane = (t % geo["eps"]) * g + ((t // geo["eps"]) << geo["fold_shift"])
            assert lane // g == t % geo["eps"] and (lane % g) >> geo["fold_shift"] == t // geo["eps"]


def _fold(d, lanes, width, steps, op):
    """The transpose reduction of ``steps`` values a lane (``d``: (32,
    steps)) over groups of ``width`` lanes, as the kernels run it: at each
    level a lane keeps one half of its values and takes its partner's half
    of the same steps. Returns the lanes' values after it."""
    d = d.copy()
    lvl, s = 0, width >> 1
    while s > 0:
        half = (steps >> lvl) >> 1
        partner = lanes ^ s
        if half > 0:
            upper = (lanes & s) != 0
            new = d.copy()
            for i in range(half):
                send = np.where(upper, d[:, i], d[:, half + i])
                keep = np.where(upper, d[:, half + i], d[:, i])
                new[:, i] = op(keep, send[partner])
            d = new
        else:
            d[:, 0] = op(d[:, 0], d[partner, 0])
        lvl, s = lvl + 1, s >> 1
    return d


def _k2_walk(csr_t, w, g, fs, heads, elem, chunk):
    """K2 by its kernel's index arithmetic (``csrc/spmm_sddmm_rowmask.cu``,
    aligned rows) in f64 without the bf16 roundings: items of ``chunk``
    edges, column tiles, batches of 32 (col, w) pairs, rounds of the
    groups' gathers, both products, the one-head dw fold and its hand-over
    to the lane of each edge's place, the heads' dots and their stores, the
    groups' meeting and dh's stores. Checks each gather and counts each
    store; returns (dh, dw)."""
    from stgraph_tpu_torch.ops.spmm_kernels import k1_work_items

    n, hf = fs.shape
    geo = _k2_geometry(hf, elem)
    gl, tile, v, eps, steps, rnd = geo["g"], geo["tile"], geo["v"], geo["eps"], geo["steps"], geo["rnd"]
    head_f = hf // heads
    nh = 1 if head_f >= v else v // head_f
    lph = head_f // v if nh == 1 else 1
    indptr, _, cols, _ = csr_t.host_arrays()
    e_real, cap = int(indptr[-1]), csr_t.capacity
    ld = -(-hf // v) * v
    table = np.zeros((csr_t.num_cols, ld))
    table[:, :hf] = g.double().numpy()
    fs, w = fs.double().numpy(), w.double().numpy().reshape(cap, heads)
    lanes = np.arange(32)
    grp, col = lanes // gl, (lanes % gl) * v
    dh = np.full((n, hf), np.nan)
    dw = np.full((cap, heads), np.nan)
    dw[e_real:] = 0.0
    dh_stores, dw_stores = np.zeros((n, hf), np.int64), np.zeros((cap, heads), np.int64)
    item_row, item_beg, split_rows = k1_work_items(indptr, chunk)
    dh[split_rows] = 0.0
    for row, beg in zip(item_row, item_beg):
        beg, row_end = int(beg), int(indptr[row + 1])
        end = min(beg + chunk, row_end)
        split = row_end - int(indptr[row]) > chunk
        for c0 in range(0, hf, tile):
            tw = min(tile, hf - c0)
            active = col < tw
            cidx = col[:, None] + np.arange(v)
            x = np.where(cidx < tw, fs[row, np.minimum(c0 + cidx, hf - 1)], 0.0)
            head0 = np.minimum(c0 + col, hf - 1) // head_f
            opens = active & ((nh > 1) | ((c0 + col) % head_f == 0))
            khead = head0[:, None] + (np.arange(v) * nh // v)  # each column's head
            acc = np.zeros((32, v))
            for base in range(beg, end, 32):
                cnt = min(32, end - base)
                my_col = np.where(lanes < cnt, cols[np.minimum(base + lanes, cap - 1)], 0)
                my_dw = np.zeros(32)
                for j0 in range(0, cnt, rnd):
                    d = np.zeros((32, steps))
                    for u in range(steps):
                        j = j0 + u * eps + grp
                        ok = (j < cnt) & active
                        src = my_col[j]
                        q = np.zeros((32, v))
                        for lane in np.flatnonzero(ok):
                            assert c0 + col[lane] + v <= ld  # inside the padded row
                            q[lane] = table[src[lane], c0 + col[lane]:c0 + col[lane] + v]
                        wt = np.where(ok[:, None], w[np.minimum(base + j, cap - 1)[:, None], khead], 0.0)
                        acc += q * wt
                        prod = x * q
                        if heads == 1:
                            d[:, u] = prod.sum(1)
                        else:
                            dots = np.stack([prod[:, (np.arange(v) * nh // v) == h].sum(1) for h in range(nh)], 1)
                            s = lph >> 1
                            while s > 0:
                                dots[:, 0] = dots[:, 0] + dots[lanes ^ s, 0]
                                s >>= 1
                            for lane in np.flatnonzero(opens & (j < cnt)):
                                e = base + j[lane]
                                dw[e, head0[lane]:head0[lane] + nh] = dots[lane]
                                dw_stores[e, head0[lane]:head0[lane] + nh] += 1
                    if heads == 1:
                        folded = _fold(d, lanes, gl, steps, np.add)
                        t = (lanes - j0) & (rnd - 1)
                        frm = (t % eps) * gl + ((t // eps) << geo["fold_shift"])
                        sel = (lanes >= j0) & (lanes < j0 + rnd)
                        my_dw[sel] = folded[frm, 0][sel]
                if heads == 1:
                    e = base + np.arange(cnt)
                    dw[e, 0] = my_dw[:cnt] if c0 == 0 else dw[e, 0] + my_dw[:cnt]
                    if c0 == 0:
                        dw_stores[e, 0] += 1
            tot = acc.reshape(eps, gl, v).sum(0)  # the groups meet in lanes 0 .. gl - 1
            for sub in range(gl):
                for k in range(v):
                    c = sub * v + k
                    if c < tw:
                        dh[row, c0 + c] = (dh[row, c0 + c] + tot[sub, k]) if split else tot[sub, k]
                        dh_stores[row, c0 + c] += 1
    assert np.all(dw_stores[:e_real] == 1)  # every real (edge, head) stored once
    deg = np.diff(indptr)
    assert np.all(dh_stores[deg <= chunk] == 1)
    assert np.all(dh_stores[deg > chunk] == -(-deg[deg > chunk] // chunk)[:, None])
    return dh, dw


@pytest.mark.parametrize("heads,f,elem", [
    (1, 128, 2), (1, 47, 2), (1, 128, 4), (1, 300, 2), (1, 200, 4),  # one head; one and two tiles
    (32, 4, 2), (32, 4, 4), (4, 32, 2), (64, 2, 2), (64, 2, 4),  # heads: in a lane, or over lanes
])
@pytest.mark.parametrize("chunk", [37, 7])
def test_k2_walk_matches_plain(heads, f, elem, chunk):
    """K2 by its walk's index arithmetic (``_k2_walk``) against its plain
    version (f32 stream) on a transpose CSR with empty rows and a hub in
    each direction split into items of ``chunk`` edges (items ending inside
    a group's step and inside a round), to 1e-5 relative."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd_plain

    rng = np.random.default_rng(heads * 1000 + f)
    n = 48
    src, dst = rng.integers(0, n - 5, 300), rng.integers(0, n - 5, 300)
    dst[:70] = 3
    src[-60:] = 7
    csr_t = build_csr(src, dst, n, capacity=305, device="cpu").transpose()
    hf = heads * f
    g, fs = (torch.from_numpy(rng.standard_normal((n, hf)).astype(np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((csr_t.capacity, heads)).astype(np.float32))
    dh, dw = _k2_walk(csr_t, w, g, fs, heads, elem, chunk)
    ref_dh, ref_dw = spmm_rowmask_bwd_plain(csr_t, w, g, fs, torch.float32, heads=heads)
    np.testing.assert_allclose(dh, ref_dh.double().numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, ref_dw.double().numpy().reshape(dw.shape), rtol=1e-5, atol=1e-5)


def _atomic_max_bits(old, v):
    """``atomic_max_float`` of ``csrc/segment_max_narrow.cu`` on f32 bits:
    an int max for non-negative bit patterns, an unsigned min otherwise."""
    o, b = np.float32(old).view(np.int32), np.float32(v).view(np.int32)
    if b >= 0:
        return np.int32(max(o, b)).view(np.float32)
    return np.uint32(min(o.view(np.uint32), b.view(np.uint32))).view(np.float32)


def _k4_walk(csr, vals, index, chunk, lanes_per_item):
    """K4 by its kernel's index arithmetic (``csrc/segment_max_narrow.cu``):
    items of ``chunk`` edges, ``lanes_per_item`` lanes an item, batches of
    kU edges a lane with the next batch's indices loaded ahead, the
    lanes' transpose meeting, the stores, and split rows met by the atomic
    float max and finished by the last item's ticket. Returns the output
    (f32) and the tickets after the launch."""
    from stgraph_tpu_torch.ops.spmm_kernels import k1_work_items

    kl = lanes_per_item
    k = vals.shape[1]
    kp = 1 << (k - 1).bit_length()
    ku = 8 if k <= 2 else 4 if k <= 8 else 2
    kr = kp // kl if kp > kl else 1
    indptr = csr.host_arrays()[0]
    vals = vals.numpy()
    index = None if index is None else index.numpy()
    item_row, item_beg, split_rows = k1_work_items(indptr, chunk)
    out = np.full((csr.num_nodes, k), np.nan, np.float32)
    out[split_rows] = -np.inf
    tickets = np.zeros(split_rows.size, np.int64)
    sl = np.arange(kl)
    for row, beg in zip(item_row, item_beg):
        beg, row_beg, row_end = int(beg), int(indptr[row]), int(indptr[row + 1])
        end = min(beg + chunk, row_end)
        split = row_end - row_beg > chunk

        def indices(b0):
            e = b0 + np.arange(ku)[:, None] * kl + sl
            return np.where(e < end, e if index is None else index[np.minimum(e, index.size - 1)], -1)

        acc = np.full((kl, kp), -np.inf, np.float32)
        idx = indices(beg)
        for b0 in range(beg, end, ku * kl):
            v = np.where(idx[..., None] >= 0, vals[np.maximum(idx, 0)], np.float32(-np.inf))  # (kU, kL, K)
            idx = indices(b0 + ku * kl)
            acc[:, :k] = np.maximum(acc[:, :k], v.max(0))
        lanes = np.arange(32)
        full = np.full((32, kp), -np.inf, np.float32)
        full[:kl] = acc  # the warp's first item; the levels stay inside it (xor < kL)
        acc = _fold(full, lanes, kl, kp, np.maximum)[:kl]
        c0 = sl >> (_log2(kl) - _log2(kp)) if kp <= kl else sl * kr
        stores = (sl & (kl // kp - 1)) == 0 if kp <= kl else np.ones(kl, bool)
        for lane in np.flatnonzero(stores):
            for i in range(kr):
                c = c0[lane] + i
                if c < k:
                    if split:
                        out[row, c] = _atomic_max_bits(out[row, c], acc[lane, i])
                    else:
                        out[row, c] = 0.0 if acc[lane, i] == -np.inf else acc[lane, i]
        if split:
            slot = int(np.searchsorted(split_rows, row))
            tickets[slot] += 1
            if tickets[slot] == -(-(row_end - row_beg) // chunk):
                tickets[slot] = 0
                out[row][out[row] == -np.inf] = 0.0
    return out, tickets


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("form", ["index", "per edge"])
def test_k4_walk_matches_plain_bit_for_bit(k, form):
    """K4 by its walk's index arithmetic (``_k4_walk``) against its plain
    version, equal bit for bit (a maximum is exact), with empty rows, a
    row of -inf values, all-negative rows, -0.0 values and two hubs split
    into items of 37 and 64 edges, at 8, 16 and 32 lanes an item; every
    split row's ticket is back at zero after the launch."""
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow_plain

    rng = np.random.default_rng(k * 10 + (form == "index"))
    n = 48
    src, dst = rng.integers(0, n - 5, 400), rng.integers(0, n - 5, 400)
    dst[:90] = 3
    dst[90:160] = 9
    dst[160:170] = 11
    csr = build_csr(src, dst, n, capacity=405, device="cpu")
    rows = n if form == "index" else csr.capacity
    vals = rng.standard_normal((rows, k)).astype(np.float32)
    vals[vals > 0.5] *= -1  # many rows all negative
    if form == "index":
        vals[rng.integers(0, n, 6)] = -0.0
        index = csr.cols
    else:
        e9 = np.flatnonzero(csr.rows.numpy() == 11)
        vals[e9] = -np.inf  # row 11: every value -inf
        vals[rng.integers(0, rows, 20)] = -0.0
        index = None
    t = torch.from_numpy(vals)
    ref = segment_max_narrow_plain(csr, t, index=index).numpy()
    for chunk in (37, 64):
        for lanes in (8, 16, 32):
            out, tickets = _k4_walk(csr, t, index, chunk, lanes)
            assert np.array_equal(out, ref), (chunk, lanes)
            assert not tickets.any()


def _k5_walk(csr, vals, chunk, rng, lanes=16, ku=4):
    """K5 by its kernel's index arithmetic (``csrc/segment_max_wide.cu``):
    ``k5_work_items`` at ``chunk`` edges, ``lanes`` lanes an item, column
    tiles of 4 ``lanes`` columns split into power-of-two column groups and
    edge offsets, batches of ``ku`` edges a lane, the offsets' xor meeting,
    and split rows met by the atomic float max in scratch rows of -inf,
    finished by the last (item, tile) to take its row's ticket. The (item,
    tile) pairs run in a random order. Returns the output (f32, NaN where
    unwritten), the tickets and the scratch after the launch."""
    from stgraph_tpu_torch.ops.segment_kernels import k5_work_items

    v = vals.numpy()
    n, k = csr.num_nodes, v.shape[1]
    items, split_rows, split_items = k5_work_items(csr.host_arrays()[0], chunk)
    out = np.full((n, k), np.nan, np.float32)
    scratch = np.full((split_rows.size, k), -np.inf, np.float32)
    tickets = np.zeros(split_rows.size, np.int64)
    tile_w = 4 * lanes
    tiles = -(-k // tile_w)
    sl = np.arange(lanes)
    for flat in rng.permutation(items.shape[0] * tiles):
        code, beg, end, slot = (int(x) for x in items[flat % items.shape[0]])
        c0 = flat // items.shape[0] * tile_w
        split, row = code < 0, ~code if code < 0 else code
        kt = min(tile_w, k - c0)
        gp = 1
        while 4 * gp < kt:
            gp *= 2
        step = lanes // gp
        col, off = 4 * (sl % gp), sl // gp
        acc = np.full((lanes, 4), -np.inf, np.float32)
        seen = np.zeros((gp, max(end - beg, 0)), np.int64)  # edges read by each column group
        for lane in range(lanes):
            ncol = min(4, kt - col[lane])
            if ncol <= 0:
                continue
            for b0 in range(beg + off[lane], end, ku * step):  # batches; the next loaded ahead
                for u in range(ku):
                    e = b0 + u * step
                    if e < end:
                        acc[lane, :ncol] = np.maximum(acc[lane, :ncol], v[e, c0 + col[lane]:c0 + col[lane] + ncol])
                        seen[lane % gp, e - beg] += 1
        assert np.all(seen[: -(-kt // 4)] == 1)  # every edge once for every column group
        s = gp
        while s < lanes:
            acc = np.maximum(acc, acc[sl ^ s])
            s *= 2
        for lane in range(gp):
            for c in range(min(4, kt - col[lane])):
                j = c0 + col[lane] + c
                if split:
                    scratch[slot, j] = _atomic_max_bits(scratch[slot, j], acc[lane, c])
                else:
                    out[row, j] = 0.0 if acc[lane, c] == -np.inf else acc[lane, c]
        if split:
            tickets[slot] += 1
            if tickets[slot] == split_items[slot] * tiles:
                tickets[slot] = 0
                out[row] = np.where(scratch[slot] == -np.inf, np.float32(0), scratch[slot])
                scratch[slot] = -np.inf
    return out, tickets, scratch


@pytest.mark.parametrize("k", [5, 17, 32, 130])
def test_k5_walk_matches_plain_bit_for_bit(k):
    """K5 by its walk's index arithmetic (``_k5_walk``) against its plain
    version, equal bit for bit (a maximum is exact), with empty rows, a
    row of -inf values, all-negative rows, -0.0 values and two hubs split
    into items of 37 and 64 edges, the (item, tile) pairs in two random
    orders; every ticket is back at zero and every scratch row at -inf
    after the launch, and every row is written."""
    from stgraph_tpu_torch.ops.segment_kernels import k5_work_items, segment_max_wide_plain

    rng = np.random.default_rng(k)
    n = 48
    src, dst = rng.integers(0, n - 5, 400), rng.integers(0, n - 5, 400)
    dst[:90] = 3
    dst[90:160] = 9
    dst[160:170] = 11
    csr = build_csr(src, dst, n, capacity=405, device="cpu")
    vals = rng.standard_normal((csr.capacity, k)).astype(np.float32)
    vals[vals > 0.5] *= -1  # many rows all negative
    vals[csr.rows.numpy() == 11] = -np.inf  # row 11: every value -inf
    vals[rng.integers(0, csr.capacity, 20)] = -0.0
    t = torch.from_numpy(vals)
    ref = segment_max_wide_plain(csr, t).numpy()
    for chunk in (37, 64):
        items, split_rows, split_items = k5_work_items(csr.host_arrays()[0], chunk)
        deg = np.diff(csr.host_arrays()[0].astype(np.int64))
        assert list(split_rows) == [3, 9] and np.array_equal(split_items, -(-deg[[3, 9]] // chunk))
        for order in range(2):
            out, tickets, scratch = _k5_walk(csr, t, chunk, np.random.default_rng(order))
            assert np.array_equal(out, ref), (chunk, order)
            assert not tickets.any() and np.all(scratch == -np.inf)


def _k3_walk(csr, vals, chunk, rng, lanes=8):
    """K3 by its kernel's arithmetic (``csrc/segment_sum_narrow.cu``) in f32:
    ``_k3_plan``'s items (``k5_work_items`` at ``chunk`` edges) run in a
    random order, ``lanes`` lanes an item, batches of kU edges a lane (the
    next batch loaded before this one's adds), the lanes' transpose
    meeting, unsplit rows stored side by side, and each item of a split row
    storing its sums in its own scratch slot; the item that takes the row's
    last ticket sums the row's slots (lane l the slots l, l + lanes, ...,
    each in item order, then the same meeting), stores the row and resets
    the ticket. Returns the output (f32, NaN where unwritten) and the
    tickets after the launch."""
    from stgraph_tpu_torch.ops.segment_kernels import _k3_plan

    v = vals.numpy()
    n, k = csr.num_nodes, v.shape[1]
    items, split, tickets, scratch = (t.numpy() for t in _k3_plan(csr, chunk, k))
    tickets = tickets.copy().astype(np.int64)
    kp = 1 << (k - 1).bit_length()
    ku = 8 if k <= 4 else 4 if k <= 8 else 2
    kr = kp // lanes if kp > lanes else 1
    sl = np.arange(lanes)
    c0 = sl >> (_log2(lanes) - _log2(kp)) if kp <= lanes else sl * kr
    holds = (sl & (lanes // kp - 1)) == 0 if kp <= lanes else np.ones(lanes, bool)
    out = np.full((n, k), np.nan, np.float32)
    scratch = np.full((max(scratch.shape[0], 1), k), np.nan, np.float32)

    def meet(acc):
        full = np.zeros((32, kp), np.float32)
        full[:lanes] = acc  # the warp's first item; the levels stay inside it (xor < lanes)
        return _fold(full, np.arange(32), lanes, kp, np.add)[:lanes]

    def store(dst, acc):
        for lane in np.flatnonzero(holds):
            for i in range(kr):
                if c0[lane] + i < k:
                    dst[c0[lane] + i] = acc[lane, i]

    def batch(e0, end):
        e = e0 + np.arange(ku)[:, None] * lanes + sl  # (kU, lanes)
        return np.where((e < end)[..., None], v[np.minimum(e, v.shape[0] - 1)], np.float32(0))

    for code, beg, end, slot in items[rng.permutation(items.shape[0])]:
        acc = np.zeros((lanes, kp), np.float32)
        cur = batch(beg, end)
        for b0 in range(beg, end, ku * lanes):
            nxt = batch(b0 + ku * lanes, end)
            for u in range(ku):
                acc[:, :k] += cur[u]
            cur = nxt
        acc = meet(acc)
        if code >= 0:
            store(out[code], acc)
            continue
        first, count, first_edge, _ = split[slot]
        store(scratch[first + (beg - first_edge) // chunk], acc)
        tickets[slot] += 1
        if tickets[slot] == count:
            tickets[slot] = 0
            tot = np.zeros((lanes, kp), np.float32)
            for lane in range(lanes):
                for j in range(lane, count, lanes):
                    tot[lane, :k] += scratch[first + j]
            store(out[~code], meet(tot))
    return out, tickets


@pytest.mark.parametrize("k", [1, 4, 6, 16])
def test_k3_walk_matches_plain_and_is_the_same_in_any_item_order(k):
    """K3 by its walk's arithmetic (``_k3_walk``) against its plain version
    within 2e-4 of each output's sum of absolute terms, with empty rows,
    padding slots and three hubs split into items of 37 and 64 edges (one
    past 32 lanes' slots a hub), at 8 (the kernel's), 16 and 32 lanes an
    item, the plan's split items first; under
    two random item finishing orders the outputs are bit-identical (the
    split rows summed in a fixed order), every row is written and every
    ticket is back at zero."""
    from stgraph_tpu_torch.ops.segment_kernels import segment_sum_narrow_plain

    rng = np.random.default_rng(k + 100)
    n = 48
    src, dst = rng.integers(0, n - 5, 2000), rng.integers(0, n - 5, 2000)
    dst[:1300] = 3  # 36 items of 37 edges: past 32 lanes' slots
    dst[1300:1370] = 9
    dst[1370:1380] = 11
    csr = build_csr(src, dst, n, capacity=2005, device="cpu")
    t = torch.from_numpy(rng.standard_normal((csr.capacity, k)).astype(np.float32))
    ref = segment_sum_narrow_plain(csr, t).numpy()
    mass = segment_sum_narrow_plain(csr, t.abs()).numpy()
    for chunk in (37, 64):
        for lanes in (8, 16, 32):
            runs = [_k3_walk(csr, t, chunk, np.random.default_rng(order), lanes) for order in range(2)]
            (out, tickets), (again, tickets2) = runs
            assert not np.isnan(out).any() and not out[n - 5:].any()
            assert np.all(np.abs(out - ref) <= 2e-4 * mass + 1e-6), (chunk, lanes)
            assert np.array_equal(out.view(np.int32), again.view(np.int32)), (chunk, lanes)
            assert not tickets.any() and not tickets2.any()


def test_k5_work_items_cover_every_edge_once_with_their_split_slots():
    """``k5_work_items``: one int4 an item (row or ~row, first edge, end,
    split slot), every row in at least one item, the items of a row
    contiguous and covering its edges once, split rows coded ~row with
    their slot in ``split_rows`` and their item count."""
    from stgraph_tpu_torch.ops.segment_kernels import k5_work_items

    csr, _ = _layout(np.random.default_rng(5), n=700, e=6000, hub_deg=600)
    indptr = csr.host_arrays()[0].astype(np.int64)
    for chunk in (128, 37):
        items, split_rows, split_items = k5_work_items(indptr, chunk)
        assert items.dtype == np.int32 and items.shape[1] == 4
        code, beg, end, slot = items.T
        rows = np.where(code < 0, ~code, code)
        assert np.all(np.diff(rows) >= 0) and np.all(end - beg <= chunk) and np.all(end >= beg)
        assert np.array_equal(np.unique(rows), np.arange(csr.num_nodes))
        assert np.array_equal(beg[1:][rows[1:] == rows[:-1]], end[:-1][rows[1:] == rows[:-1]])  # contiguous
        assert np.array_equal(np.bincount(rows, weights=end - beg, minlength=csr.num_nodes), np.diff(indptr))
        deg = np.diff(indptr)
        assert np.array_equal(split_rows, np.flatnonzero(deg > chunk)) and 300 in split_rows
        assert np.array_equal(code < 0, deg[rows] > chunk)
        assert np.all(slot[code >= 0] == -1) and np.array_equal(split_rows[slot[code < 0]], rows[code < 0])
        assert np.array_equal(split_items, np.bincount(slot[code < 0], minlength=split_rows.size))


def _k7_walk(rows, w, n, mode, lanes, passes, rng):
    """K7 by its kernel's arithmetic (``csrc/rowid_denom.cu``) in f32, with
    a warp of ``lanes`` lanes (32 on the card): spans of ``passes`` passes
    of 4 ``lanes`` slots taken in ticket order, each lane's 4 slots reduced
    to (first row, last row, sum of the last row's values), the Kogge-Stone
    segmented scan, the look-back over ``lanes`` predecessors at a time
    (each predecessor's inclusive value visible or not at random, as the
    card's timing makes it; the nearest inclusive value awaited when the
    chain is longer than the window), the warp's zeroing of the rows
    strictly inside its span, then each lane's stores of the rows it
    finishes, and the zeroing of the gaps between spans. Returns ``den``
    (f32, NaN where unwritten) and how many times each row was stored a
    sum and a zero."""
    f32 = np.float32
    cap = rows.size
    span = 4 * lanes * passes
    spans = -(-cap // span)
    den = np.full(n, np.nan, f32)
    sums, zeros = np.zeros(n, np.int64), np.zeros(n, np.int64)
    none = (-1, -1, f32(0))

    def comb(a, b):
        if b[1] < 0:
            return a
        if a[1] < 0:
            return b
        return (a[0], b[1], f32(a[2] + b[2]) if b[1] == a[1] else b[2])

    def store(r, x):
        den[r] = x
        sums[r] += 1

    def zero(lo, hi):
        den[lo:hi] = 0.0
        zeros[lo:hi] += 1

    agg_of, inc_of = {}, {}
    for s in range(spans):
        e = s * span + np.arange(passes * lanes * 4).reshape(passes, lanes, 4)
        r = np.where(e < cap, rows[np.minimum(e, cap - 1)], n)
        r = np.where((r >= 0) & (r < n), r, -1)
        ww = np.where(e < cap, w[np.minimum(e, cap - 1)], f32(0)) if w is not None else None
        v = (np.ones(r.shape, f32) if mode == 0 else ww.astype(f32) if mode == 1
             else np.where(ww > 0, f32(1), f32(0)))
        ex, tot, agg = [], [], none
        for p in range(passes):
            segs = []
            for lane in range(lanes):
                m = none
                for j in range(4):
                    rj = int(r[p, lane, j])
                    if rj < 0:
                        continue
                    m = (rj, rj, v[p, lane, j]) if m[1] < 0 else (
                        (m[0], rj, f32(m[2] + v[p, lane, j])) if rj == m[1] else (m[0], rj, v[p, lane, j]))
                segs.append(m)
            x, d = list(segs), 1
            while d < lanes:
                x = [comb(x[i - d], x[i]) if i >= d else x[i] for i in range(lanes)]
                d *= 2
            ex.append([none] + x[:-1])
            tot.append(x[-1])
            agg = comb(agg, x[-1])
        agg_of[s] = agg
        zero(agg[0] + 1, max(agg[1], agg[0] + 1))  # the rows strictly inside the span, before any sum
        carry = none
        if s > 0:
            q0 = s - 1
            while True:
                window = []  # (inclusive?, f, l, s) of s-1-lane
                for lane in range(lanes):
                    q = q0 - lane
                    if q < 0:
                        window.append((True, -1, -1, f32(0)))
                    elif rng.random() < 0.5:
                        window.append((True,) + inc_of[q])
                    else:
                        window.append((False,) + agg_of[q])
                info = [i for i, d_ in enumerate(window) if d_[0] or d_[2] >= 0]
                if not info:
                    q0 -= lanes
                    continue
                i0 = info[0]
                row = window[i0][2]
                if row < 0:
                    break
                ends = [i for i in range(i0, lanes) if window[i][0]
                        or (window[i][2] >= 0 and (window[i][2] != row or window[i][1] != window[i][2]))]
                if not ends:
                    carry = (row, row, inc_of[s - 1][2])  # the nearest inclusive value, awaited
                    assert inc_of[s - 1][1] == row
                    break
                total = None
                for i in range(ends[0], i0 - 1, -1):  # oldest first
                    if window[i][2] == row:
                        total = window[i][3] if total is None else f32(total + window[i][3])
                carry = (row, row, total)
                break
        inc_of[s] = comb(carry, agg)
        c = carry
        for p in range(passes):
            for lane in range(lanes):
                _, prev, acc = comb(c, ex[p][lane])
                for j in range(4):
                    rj = int(r[p, lane, j])
                    if rj < 0:
                        continue
                    if rj != prev:
                        if prev >= 0:
                            store(prev, acc)
                        if prev < agg[0]:  # the gap before the span's first live row, by the warp
                            zero(prev + 1, rj)
                        prev, acc = rj, f32(0)
                    acc = f32(acc + v[p, lane, j])
            c = comb(c, tot[p])
    last = inc_of[spans - 1]
    if last[1] >= 0:
        store(last[1], last[2])
    zero(last[1] + 1, n)
    return den, sums, zeros


def _k7_stores():
    """The adversarial store of K6's plan tests and three random ones (a
    ragged last span, 30 % sentinels, a run of 200 sentinel slots, a hub
    of 300 slots), each with positive weights and 10 % tombstones."""
    rows, _, w, n = _adversarial_store()
    yield "adversarial", rows, w, n
    for seed in range(3):
        rng = np.random.default_rng(seed)
        n, cap = 300, 2000 + seed
        r = np.sort(rng.integers(0, n - 30, cap))
        r[:300] = 17
        r = np.sort(r)
        r[rng.random(cap) < 0.3] = n
        r[1200:1400] = n
        w = np.where((r < n) & (rng.random(cap) > 0.1), rng.random(cap) + 0.1, 0.0).astype(np.float32)
        yield f"random{seed}", r.astype(np.int32), w, n


@pytest.mark.parametrize("lanes,passes", [(4, 1), (4, 2), (32, 1), (32, 2)])
def test_k7_walk_matches_plain_and_writes_every_row_once(lanes, passes):
    """K7 by its walk (``_k7_walk``) on the adversarial and random stores
    of K6's plan tests, at two span lengths and two warp widths (4 lanes:
    a look-back window of 4 spans, so chains outrun it): counts and
    indicator sums bit-equal to ``dyn_degree_plain``, weighted sums within
    2e-4 of each row's sum; every row that has a slot stored its sum
    exactly once (after at most one zero, from its span's bulk zeroing),
    every row without one zeroed exactly once; the weighted sums bit for
    bit the same under another timing of the look-back (a fixed order)."""
    for name, rows, w, n in _k7_stores():
        r_t, w_t = torch.from_numpy(rows), torch.from_numpy(w)
        has = np.zeros(n, bool)
        has[rows[rows < n]] = True
        for mode in (0, 1, 2):
            ref = RK.dyn_degree_plain(r_t, None if mode == 0 else torch.where(w_t > 0, 1.0, 0.0)
                                      if mode == 2 else w_t, n).numpy()
            den, sums, zeros = _k7_walk(rows, None if mode == 0 else w, n, mode, lanes, passes,
                                        np.random.default_rng(mode))
            assert np.array_equal(sums, has.astype(np.int64)), (name, mode)
            assert np.all(zeros[~has] == 1) and np.all(zeros[has] <= 1), (name, mode)
            if mode == 1:
                np.testing.assert_allclose(den, ref, rtol=2e-4, atol=1e-6)
                again, *_ = _k7_walk(rows, w, n, mode, lanes, passes, np.random.default_rng(99))
                assert np.array_equal(den, again), name
            else:
                assert np.array_equal(den, ref), (name, mode)


def test_dyn_degree_indicator_mode_on_the_cpu_is_the_plain_version_of_the_indicator():
    rows, _, w, n = _adversarial_store()
    r_t, w_t = torch.from_numpy(rows), torch.from_numpy(w)
    got = RK.dyn_degree(r_t, w_t, n, indicator=True)
    assert torch.equal(got, RK.dyn_degree_plain(r_t, torch.where(w_t > 0, 1.0, 0.0), n))
    assert got[7] == 0 and got[5] == 21  # row 7: tombstones only; row 5: 24 slots less 3 sentinels
    with pytest.raises(ValueError):
        RK.dyn_degree(r_t, None, n, indicator=True)
