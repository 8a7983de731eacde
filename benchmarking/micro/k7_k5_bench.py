#!/usr/bin/env python3
"""Time K7 (the row-id degree) and K5 (the wide segment max) of the
PyTorch/CUDA port on one NVIDIA GPU, with their parts apart, at every shape
of ``chip_smoke.py``'s main paths that launches them:

- K7 as ``lazy_norm`` calls it (the indicator of ``w > 0``) on the lazy
  store pair's forward store after the last timestep of the DTDG epochs
  (England-COVID, 129 nodes; the wiki-talk-shaped stream, 20,000 nodes) and
  on the dyn-step store after its 64 steps (1.1M nodes, 2.2M slots);
- K5 at 32 heads on the rowmask route's graphs: the synthetic Pubmed
  (88,648 edges) and the PPI-sized graph (818,716 edges).

Phases (``--only``):

- ``parts``: the first designs' parts, built from ``--baseline-csrc`` (a copy
  of the first design's ``rowid_denom.cu`` and ``segment_max_wide.cu``):
  the whole wrapper as the path called it, the kernel alone, and
  ``k7_k5_parts.cu``'s probes: for K7 the slot stream alone (no atomic) and
  the atomics alone (no slot read), and the wrapper's ``torch.zeros`` and
  ``lazy_norm``'s ``torch.where``; for K5 the item walk alone (no value
  read) and the value stream with its bounds at hand (no dependent chain),
  and the split rows' passes (``index_fill_``, ``clear_neg_inf_kernel``).
- ``check``: the port's K7 (every mode) and K5 at every shape into
  NaN-poisoned outputs against their plain versions, untimed.
- ``turns``: the first design and the port, each through its whole wrapper
  as the path calls it, timed in turns (first, port, port, first) at every
  shape, each output held against the plain version, with its bound, its
  library call (``bincount``; ``segment_reduce``), and each call's device
  time and launches by the profiler.
- ``spans``: the port's K5 at items of 128, 256, 512 and 1024 edges, swept
  up then down.
- ``variants``: K7's plan design (``k7_k5_parts.cu``, two launches) against
  the port's look-back design, and edited copies of the port's sources
  (``VARIANTS``: K5 with 8 and 32 lanes an item and half and twice the edges
  in flight; K7 at spans of 1 and 4 passes of 128 slots where the source
  has 2, with a ticket a block, with a sleep in its spin, with its gaps
  zeroed where a lane meets them, and its parts alone), in turns, with
  device times.
- ``sass``: the port's and the first designs' K7 and K5 built side by side
  with ``-Xptxas -v``: registers and spills of every instance.

    python3 benchmarking/micro/k7_k5_bench.py [--only parts,check,turns,spans,variants,sass]
        [--baseline-csrc DIR] [--out PATH] [--sass-dir DIR]

Inputs are random from a seed where the path's are (a kernel's time does not
depend on the values). It prints one line per measurement and, last, the
card's name and power limit; ``--out`` writes every number as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (the paths' shapes, bounds, timers and checks)
import k1_bench as kb  # noqa: E402  (record, turns)
import k2_k4_bench as k24  # noqa: E402  (the Pubmed and PPI graphs)
import k8_k9_bench as k89  # noqa: E402  (parallel nvcc builds, ptxas parsing)

_VP, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
FIRST_CHUNK = 1024  # the first K5's items
FIRST_DENOM_CHUNK = 16  # the first K7's slots a thread
record = kb.record
FIRST_K7 = [_VP, _VP, _VP, _I64, _I, _I, _VP]
FIRST_K5 = [_VP, _VP, _VP, _VP, _I, _VP, _I, _VP, _I, _I, _VP]
PARTS = {
    "stg_k7_probe": [_VP, _VP, _VP, _I64, _I, _I, _I, _VP],
    "stg_k5_probe": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _I, _VP],
    "stg_k5_clear_neg_inf": [_VP, _I, _I, _VP, _VP],
    "stg_k7_plan_design": [_VP, _VP, _VP, _VP, _I64, _I, _I, _I, _VP],
}
K7_SHAPES = ("england-covid", "wiki-shape", "dyn-step")
K5_SHAPES = ("pubmed", "ppi")


def stream():
    return torch.cuda.current_stream().cuda_stream


class First:
    """The first designs of K7 and K5, built from ``--baseline-csrc``, called
    as their wrappers called them, and ``k7_k5_parts.cu`` (the probes, the
    first K5's second kernel and K7's plan design)."""

    def __init__(self, csrc):
        jobs = {"k7_k5_parts": (os.path.join(HERE, "k7_k5_parts.cu"), [])}
        if csrc:
            jobs["first_k7"] = (os.path.join(csrc, "rowid_denom.cu"), [])
            jobs["first_k5"] = (os.path.join(csrc, "segment_max_wide.cu"), [])
        self.libs = {}
        for name, (path, log, _) in k89.nvcc_many(jobs).items():
            lib = ctypes.CDLL(path)
            for fn, argtypes in [("stg_rowid_denom", FIRST_K7), ("stg_segment_max_wide", FIRST_K5)] + list(
                    PARTS.items()):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            self.libs[name] = lib
        self.present = {}

    # K7
    def k7_kernel(self, rows, w, den, n):
        rc = self.libs["first_k7"].stg_rowid_denom(rows.data_ptr(), None if w is None else w.data_ptr(),
                                                   den.data_ptr(), rows.numel(), n, FIRST_DENOM_CHUNK, stream())
        assert rc == 0, rc

    def k7(self, rows, w, n):
        """The first wrapper: a zeroed output, then the kernel."""
        den = torch.zeros(n, dtype=torch.float32, device=rows.device)
        self.k7_kernel(rows, w, den, n)
        return den

    def k7_lazy_norm(self, rows, w, n):
        """As ``lazy_norm`` called it: the indicator weights made, then the
        first wrapper."""
        return self.k7(rows, torch.where(w > 0, 1.0, 0.0), n)

    def k7_probe(self, rows, w, den, n, phase):
        rc = self.libs["k7_k5_parts"].stg_k7_probe(rows.data_ptr(), None if w is None else w.data_ptr(),
                                                   den.data_ptr(), rows.numel(), n, FIRST_DENOM_CHUNK, phase,
                                                   stream())
        assert rc == 0, rc

    def k7_plan(self, rows, w, n, indicator, passes):
        """K7's plan design: two launches into an empty output."""
        den = torch.empty(n, dtype=torch.float32, device=rows.device)
        present = self.present.get(n)
        if present is None:
            present = self.present[n] = torch.zeros(-(-n // 32), dtype=torch.int32, device=rows.device)
        mode = 0 if w is None else (2 if indicator else 1)
        rc = self.libs["k7_k5_parts"].stg_k7_plan_design(rows.data_ptr(), None if w is None else w.data_ptr(),
                                                         den.data_ptr(), present.data_ptr(), rows.numel(), n, mode,
                                                         passes, stream())
        assert rc == 0, rc
        return den

    # K5
    @staticmethod
    def items(csr):
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        return _work_items(csr, FIRST_CHUNK)

    def k5_kernel(self, csr, plane, out):
        item_row, item_beg, split = self.items(csr)
        rc = self.libs["first_k5"].stg_segment_max_wide(
            csr.indptr.data_ptr(), plane.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(),
            split.data_ptr(), split.numel(), out.data_ptr(), plane.shape[1], FIRST_CHUNK, stream())
        assert rc == 0, rc

    def k5(self, csr, vals):
        """The first wrapper: the split rows filled with -inf, then the C
        entry (the kernel and, with split rows, its second kernel)."""
        plane = vals.to(torch.float32).contiguous()
        out = torch.empty(csr.num_nodes, plane.shape[1], dtype=torch.float32, device=vals.device)
        split = self.items(csr)[2]
        if split.numel():
            out.index_fill_(0, split, float("-inf"))
        self.k5_kernel(csr, plane, out)
        return out

    def k5_probe(self, csr, plane, bounds, out, phase):
        item_row, item_beg, _ = self.items(csr)
        rc = self.libs["k7_k5_parts"].stg_k5_probe(
            csr.indptr.data_ptr(), plane.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(), bounds.data_ptr(),
            item_row.numel(), out.data_ptr(), plane.shape[1], FIRST_CHUNK, phase, stream())
        assert rc == 0, rc

    def k5_clear(self, csr, out):
        split = self.items(csr)[2]
        rc = self.libs["k7_k5_parts"].stg_k5_clear_neg_inf(split.data_ptr(), split.numel(), out.shape[1],
                                                           out.data_ptr(), stream())
        assert rc == 0, rc


def k5_bounds(csr):
    """Each first-design item's (first edge, end) as a device int2 array."""
    item_row, item_beg, _ = First.items(csr)
    indptr = csr.host_arrays()[0].astype(np.int64)
    beg = item_beg.cpu().numpy().astype(np.int64)
    end = np.minimum(beg + FIRST_CHUNK, indptr[1:][item_row.cpu().numpy()])
    return torch.from_numpy(np.stack([beg, end], 1).astype(np.int32)).to(csr.device)


_STORES = {}


def dyn_store(dev, seed):
    """``chip_smoke.phase_dyn_step``'s forward store after its 64 steps (the
    same stream from the same seed, without the aggregations)."""
    from stgraph_tpu_torch.ops.dyn_spmm import apply_delta_lazy_pair, lazy_pair_from_edges

    rng = np.random.default_rng(seed)
    nodes, cap, slide, steps, tcap = cs.DYN_NODES, cs.DYN_CAP, cs.DYN_SLIDE, cs.DYN_STEPS, cs.DYN_TCAP
    e0 = cap - tcap - 40_000
    keys = np.unique(rng.integers(0, nodes, e0 * 2).astype(np.int64) * nodes + rng.integers(0, nodes, e0 * 2))[:e0]
    rows0, cols0 = (keys // nodes).astype(np.int32), (keys % nodes).astype(np.int32)
    adds, dels, _ = cs.gen_delta_stream(rng, cols0.astype(np.int64) * nodes + rows0, nodes, steps, slide)
    pair = lazy_pair_from_edges(cols0, rows0, nodes, capacity=cap, tail_capacity=tcap, device=dev)
    adds_t, dels_t = torch.from_numpy(adds).to(dev), torch.from_numpy(dels).to(dev)
    for s in range(steps):
        pair = apply_delta_lazy_pair(pair, adds_t[s, :, 0], adds_t[s, :, 1], dels_t[s, :, 0], dels_t[s, :, 1])
    return pair.fwd


def k7_stores(dev, args):
    """(shape, rows, w, n) of every K7 shape: the forward store after the
    last timestep of each DTDG stream, and the dyn-step store."""
    if not _STORES:
        for name in K7_SHAPES[:2]:
            _, _, tr = cs.dtdg_trainer(dev, name, args.data_dir)
            pair = tr.pair0
            for t in range(tr.steps):
                pair = tr.update(pair, t)
            _STORES[name] = pair.fwd
        _STORES["dyn-step"] = dyn_store(dev, args.seed)
        torch.cuda.synchronize()
    for name in K7_SHAPES:
        st = _STORES[name]
        yield name, st.rows, st.w, st.num_nodes


def k5_cases(dev, args, gen):
    """(shape, csr, vals) of every K5 shape: (capacity, 32) f32 scores."""
    h = cs.ROWMASK_PPI_TILING[0]
    for name in K5_SHAPES:
        csr = k24.small_graphs(dev, args)[name].fwd_csr
        yield name, csr, torch.randn(csr.capacity, h, device=dev, generator=gen)


def k7_bound(rows, n):
    cap = rows.numel()
    return cs.rowid_bounds(cap, n, 1, cap)[1]


def phase_parts(dev, args, first):
    with torch.inference_mode():
        for name, rows, w, n in k7_stores(dev, args):
            ind = torch.where(w > 0, 1.0, 0.0)
            den = torch.zeros(n, device=dev)
            row = dict(phase="parts", kernel="K7", shape=name, N=n, slots=rows.numel(),
                       live=int(((rows < n) & (w > 0)).sum()))
            ref = cs_plain_k7(rows, ind, n)
            row["bit_equal_first"] = bool(torch.equal(first.k7_lazy_norm(rows, w, n), ref))
            den.zero_()
            first.k7_probe(rows, ind, den, n, 0)
            row["bit_equal_probe"] = bool(torch.equal(den, ref))
            timings = {
                "lazy_norm_call_ms": lambda: first.k7_lazy_norm(rows, w, n),
                "wrapper_ms": lambda: first.k7(rows, ind, n),
                "kernel_ms": lambda: first.k7_kernel(rows, ind, den, n),
                "stream_alone_ms": lambda: first.k7_probe(rows, ind, den, n, 1),
                "atomics_alone_ms": lambda: first.k7_probe(rows, ind, den, n, 2),
                "zeros_ms": lambda: torch.zeros(n, dtype=torch.float32, device=dev),
                "where_ms": lambda: torch.where(w > 0, 1.0, 0.0),
            }
            for key, fn in timings.items():
                row[key] = cs.cuda_ms(fn, 200, warmup=5)
            row["bound_ms"] = k7_bound(rows, n)[0]
            record(**row)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 73)
        for name, csr, vals in k5_cases(dev, args, gen):
            k = vals.shape[1]
            n, e = csr.num_nodes, csr.num_edges
            split = first.items(csr)[2]
            out = torch.empty(n, k, device=dev)
            bounds = k5_bounds(csr)
            row = dict(phase="parts", kernel="K5", shape=name, K=k, N=n, E=e, split_rows=split.numel(),
                       longest_row=int(np.diff(csr.host_arrays()[0].astype(np.int64)).max()))
            ref = cs_plain_k5(csr, vals)
            row["bit_equal_first"] = bool(torch.equal(first.k5(csr, vals), ref))
            timings = {
                "wrapper_ms": lambda: first.k5(csr, vals),
                "kernel_ms": lambda: first.k5_kernel(csr, vals, out),
                "item_walk_alone_ms": lambda: first.k5_probe(csr, vals, bounds, out, 1),
                "values_bounds_at_hand_ms": lambda: first.k5_probe(csr, vals, bounds, out, 2),
                "index_fill_ms": lambda: out.index_fill_(0, split, float("-inf")),
                "clear_neg_inf_ms": lambda: first.k5_clear(csr, out),
            }
            for key, fn in timings.items():
                row[key] = cs.cuda_ms(fn, 100, warmup=3)
            row["bound_ms"] = cs.wide_bound(n, e, k)[0]
            record(**row)


def cs_plain_k7(rows, w, n):
    from stgraph_tpu_torch.ops.rowid_kernels import dyn_degree_plain

    return dyn_degree_plain(rows, w, n)


def cs_plain_k5(csr, vals):
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_wide_plain

    return segment_max_wide_plain(csr, vals, cs.COMPOSED_PLAIN_EDGE_BLOCK)


def phase_check(dev, args, first=None):
    from stgraph_tpu_torch.ops import rowid_kernels as RK
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_wide

    with torch.inference_mode():
        for name, rows, w, n in k7_stores(dev, args):
            for mode, ww, ind in (("count", None, False), ("weighted", w, False), ("indicator", w, True)):
                ref = cs_plain_k7(rows, torch.where(w > 0, 1.0, 0.0) if ind else ww, n)
                den = cs.poisoned_call((n,), lambda: RK.dyn_degree(rows, ww, n, indicator=ind))
                if mode == "weighted":
                    ok = cs._err_over_mass((den - ref).abs(), ref) <= cs.KERNEL_TOL
                else:
                    ok = bool(torch.equal(den, ref))
                record(phase="check", kernel="K7", shape=name, mode=mode, ok=ok,
                       max_abs_err=(den - ref).abs().max().item())
                cs.check(ok, f"K7 {mode} at {name} disagrees with its plain version")
        gen = torch.Generator(device=dev).manual_seed(args.seed + 79)
        for name, csr, vals in k5_cases(dev, args, gen):
            segment_max_wide(csr, vals)
            out = cs.poisoned_call((csr.num_nodes, vals.shape[1]), lambda: segment_max_wide(csr, vals))
            ok = bool(torch.equal(out, cs_plain_k5(csr, vals)))
            record(phase="check", kernel="K5", shape=name, bit_equal=ok)
            cs.check(ok, f"K5 at {name} differs from its plain version")


def phase_turns(dev, args, first):
    from stgraph_tpu_torch.ops.rowid_kernels import dyn_degree
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_wide

    with torch.inference_mode():
        for name, rows, w, n in k7_stores(dev, args):
            ind = torch.where(w > 0, 1.0, 0.0)
            ref = cs_plain_k7(rows, ind, n)
            cases = {  # lazy_norm's call as each design makes it, and the kernels on the same weights
                "lazy_norm": (lambda: first.k7_lazy_norm(rows, w, n), lambda: dyn_degree(rows, w, n, indicator=True)),
                "weights": (lambda: first.k7(rows, ind, n), lambda: dyn_degree(rows, ind, n)),
            }
            for call, (old, new) in cases.items():
                equal_new = bool(torch.equal(cs.poisoned_call((n,), new), ref))
                equal_first = bool(torch.equal(old(), ref))
                cs.check(equal_new, f"K7 ({call}) at {name} differs from its plain version")
                (o1, o2), (n1, n2) = kb._turns(old, new, 200)
                bound = k7_bound(rows, n)
                try:  # a timed yardstick only; the port never calls it
                    lib = cs.cuda_ms(lambda: torch.bincount(rows, weights=ind, minlength=n + 1), 100)
                except RuntimeError:
                    lib = None
                record(phase="turns", kernel="K7", shape=name, call=call, N=n, slots=rows.numel(), first_ms=[o1, o2],
                       new_ms=[n1, n2], first_device=device_profile(old), new_device=device_profile(new),
                       bit_equal_new=equal_new, bit_equal_first=equal_first, bound_ms=bound[0],
                       bound_by=bound[1], library_ms=lib)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 83)
        for name, csr, vals in k5_cases(dev, args, gen):
            n, e, k = csr.num_nodes, csr.num_edges, vals.shape[1]
            new = lambda: segment_max_wide(csr, vals)  # noqa: E731
            old = lambda: first.k5(csr, vals)  # noqa: E731
            new()
            ref = cs_plain_k5(csr, vals)
            equal_new = bool(torch.equal(cs.poisoned_call((n, k), new), ref))
            equal_first = bool(torch.equal(old(), ref))
            cs.check(equal_new, f"K5 at {name} differs from its plain version")
            (o1, o2), (n1, n2) = kb._turns(old, new, 100)
            bound = cs.wide_bound(n, e, k)
            record(phase="turns", kernel="K5", shape=name, K=k, N=n, E=e, first_ms=[o1, o2], new_ms=[n1, n2],
                   first_device=device_profile(old), new_device=device_profile(new), bit_equal_new=equal_new,
                   bit_equal_first=equal_first, bound_ms=bound[0], bound_by=bound[1],
                   library_ms=cs._library_segment_sum_ms(csr, vals, e, "max"))


def phase_spans(dev, args, first=None):
    from stgraph_tpu_torch.ops import segment_kernels as SEG

    saved5 = SEG.K5_CHUNK
    try:
        with torch.inference_mode():
            gen = torch.Generator(device=dev).manual_seed(args.seed + 89)
            for name, csr, vals in k5_cases(dev, args, gen):
                for chunk in (128, 256, 512, 1024, 1024, 512, 256, 128):
                    SEG.K5_CHUNK = chunk
                    fn = lambda: SEG.segment_max_wide(csr, vals)  # noqa: E731
                    record(phase="spans", kernel="K5", shape=name, chunk=chunk, ms=cs.cuda_ms(fn, 100, warmup=3),
                           device_ms=device_profile(fn)[0])
    finally:
        SEG.K5_CHUNK = saved5


K5_SRC, K7_SRC = "segment_max_wide.cu", "rowid_denom.cu"
K5_L = "constexpr int kL = 16;          // lanes a work item"
K5_U = "constexpr int kU = 4;           // edges a lane keeps in flight"
K7_P = "constexpr int kP = 2;              // passes a span (1 and 4 measured slower, PERF.md §6)"
K7_TICKET = """  int s = 0;
  if (lane == 0) {
    s = static_cast<int>(atomicAdd(ticket, 1u));
    if (s == spans - 1) *ticket = 0u;  // every span has its ticket: ready for the next launch
  }
  s = __shfl_sync(kFull, s, 0);
"""
K7_SPIN = "          d = load_status(status + q);\n"
K7_SCAN = "  // each lane's runs, scanned over the warp pass by pass\n"
K7_PUBLISH = "  // publish the aggregate, find the carry"
K7_BULK = "  for (int i = agg.f + 1 + lane; i < agg.l; i += 32) den[i] = 0.f;\n  __syncwarp();\n"
K7_FIRST_GAP = """        if (prev < agg.f) {  // the span's first live slot, after rows of no slot
          lo = prev + 1;
          len = rj - prev - 1;
        }
"""
# The port's K5 and K7 taken apart: (source, edits) of a copy of csrc/
VARIANTS = {
    "k5_source": (K5_SRC, ()),
    "k5_lanes_8": (K5_SRC, ((K5_L, "constexpr int kL = 8;"),)),
    "k5_lanes_32": (K5_SRC, ((K5_L, "constexpr int kL = 32;"),)),
    "k5_u_2": (K5_SRC, ((K5_U, "constexpr int kU = 2;"),)),
    "k5_u_8": (K5_SRC, ((K5_U, "constexpr int kU = 8;"),)),
    "k7_source": (K7_SRC, ()),
    "k7_passes_1": (K7_SRC, ((K7_P, "constexpr int kP = 1;"),)),
    "k7_passes_4": (K7_SRC, ((K7_P, "constexpr int kP = 4;"),)),
    # one ticket a block of 8 spans, not a warp
    "k7_block_ticket": (K7_SRC, ((K7_TICKET, """  __shared__ int block_ticket;
  if (threadIdx.x == 0) {
    block_ticket = static_cast<int>(atomicAdd(ticket, 1u));
    if (block_ticket == static_cast<int>(gridDim.x) - 1) *ticket = 0u;
  }
  __syncthreads();
  const int s = block_ticket * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= spans) return;
"""), ("  if (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5) >= spans) return;  // warp-uniform\n",
       ""))),
    "k7_spin_sleep": (K7_SRC, ((K7_SPIN, "          d = load_status(status + q);\n"
                                         "          if ((d.w >> 1) != epoch) __nanosleep(64);\n"),)),
    # the walk's parts alone (wrong sums: timing only): the loads, then the
    # loads and the scans, then the whole without its gap zeroing or its
    # row stores
    "k7_loads_only": (K7_SRC, ((K7_SCAN, "  {\n    int x = 0;\n    float y = 0.f;\n    for (int p = 0; p < kP; ++p)\n"
                                         "      for (int j = 0; j < kV; ++j) x ^= r[p][j], y += v[p][j];\n"
                                         "    if (x == 0x7fffffff && y == -1.2345f) den[0] = y;\n    return;\n  }\n"
                                         + K7_SCAN),)),
    "k7_loads_scans": (K7_SRC, ((K7_PUBLISH, "  if (agg.s == -1.2345f) den[0] = agg.s;\n  return;\n" + K7_PUBLISH),)),
    "k7_no_gap_zeroing": (K7_SRC, ((K7_BULK, ""), ("    zero_gaps(den, lo, len, lane);\n", ""))),
    # the rows without a slot zeroed where a lane meets them (up to 8 rows;
    # longer gaps by the warp), not by the span's bulk zeroing
    "k7_lane_gaps": (K7_SRC, ((K7_BULK, ""), (K7_FIRST_GAP, """        if (rj - prev - 1 <= 8) {
          for (int g = prev + 1; g < rj; ++g) den[g] = 0.f;
        } else {
          lo = prev + 1;
          len = rj - prev - 1;
        }
"""))),
    "k7_no_row_stores": (K7_SRC, (("        if (prev >= 0) den[prev] = acc;\n",
                                   "        if (prev >= 0 && acc == -1.2345f) den[prev] = acc;\n"),)),
}
LIBS = {K5_SRC: "segment_max_wide", K7_SRC: "rowid_denom"}


def k7_span(variant):
    """The slots a span of a K7 build: the wrapper sizes its look-back words
    by it."""
    for old, new in VARIANTS[variant][1]:
        if old == K7_P:
            return 128 * int(new.split("=")[1].strip(" ;"))
    return 256


def device_profile(fn, calls=20):
    """One call of ``fn`` on the device, by the profiler over ``calls``
    calls: its device time (every kernel, fill and copy, summed), how many
    launches it makes and their names."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(ev.time_range.elapsed_us() for ev in evs) / 1e3 / calls, len(evs) / calls,
            sorted({ev.name for ev in evs}))


def phase_variants(dev, args, first):
    """K7's plan design against the port's look-back design, both through
    a call as ``lazy_norm``'s (the indicator) at the port's span, in turns;
    then each of ``VARIANTS`` (K5's and K7's sources edited) through its
    wrapper at every shape, in turns (each build, then again in reverse),
    with the call's device time by the profiler beside it."""
    from stgraph_tpu_torch.ops import kernel_lib
    from stgraph_tpu_torch.ops import rowid_kernels as RK
    from stgraph_tpu_torch.ops import segment_kernels as SEG

    with torch.inference_mode():
        for name, rows, w, n in k7_stores(dev, args) if "plan" in args.variants.split(",") else ():
            ref = cs_plain_k7(rows, torch.where(w > 0, 1.0, 0.0), n)
            plan = lambda: first.k7_plan(rows, w, n, True, RK._K7_SPAN // 128)  # noqa: E731
            look = lambda: RK.dyn_degree(rows, w, n, indicator=True)  # noqa: E731
            equal = bool(torch.equal(plan(), ref)) and bool(torch.equal(plan(), ref))
            cs.check(equal, f"K7's plan design at {name} differs from the plain version")
            (p1, p2), (l1, l2) = kb._turns(plan, look, 200)
            record(phase="variants", kernel="K7", shape=name, plan_design_ms=[p1, p2], lookback_ms=[l1, l2],
                   plan_device=device_profile(plan), lookback_device=device_profile(look), plan_bit_equal=equal)
    csrc = os.path.join(ROOT, "stgraph_tpu_torch", "csrc")
    names = [n for n in args.variants.split(",") if n in VARIANTS]
    jobs = {}
    for name in names:
        src, edits = VARIANTS[name]
        with open(os.path.join(csrc, src)) as fh:
            text = fh.read()
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        d = os.path.join(k89.BUILD_DIR, f"k7k5_variant_{name}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, src), "w") as fh:
            fh.write(text)
        jobs[name] = (os.path.join(d, src), [])
    libs = {}
    for name, (path, log, _) in k89.nvcc_many(jobs).items():
        inst = k89.ptxas_instances(log)
        record(phase="variants", library=name, registers=[i[1] for i in inst], spilled=[i[2] for i in inst])
        lib = ctypes.CDLL(path)
        sigs = SEG._K5_SIGNATURES if VARIANTS[name][0] == K5_SRC else RK._K7_SIGNATURES
        for fn, sig in sigs.items():
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    saved = {lib: kernel_lib._loaded.get(lib) for lib in LIBS.values()}
    saved_span = RK._K7_SPAN
    gen = torch.Generator(device=dev).manual_seed(args.seed + 97)
    try:
        with torch.inference_mode():
            calls = {K5_SRC: {name: (lambda c=csr, v=vals: SEG.segment_max_wide(c, v))
                              for name, csr, vals in k5_cases(dev, args, gen)},
                     K7_SRC: {name: (lambda r=rows, w=w, n=n: RK.dyn_degree(r, w, n, indicator=True))
                              for name, rows, w, n in k7_stores(dev, args)}}
            times = {}
            for variant in names + names[::-1]:
                src = VARIANTS[variant][0]
                kernel_lib._loaded[LIBS[src]] = libs[variant]
                if src == K7_SRC:
                    RK._K7_SPAN = k7_span(variant)
                for key, fn in calls[src].items():
                    times.setdefault(f"{key}:{variant}", []).append(round(cs.cuda_ms(fn, 100, warmup=3), 5))
                    times.setdefault(f"{key}:{variant}:device", []).append(round(device_profile(fn)[0], 5))
            record(phase="variants", **times)
    finally:
        RK._K7_SPAN = saved_span
        for lib, v in saved.items():
            if v is None:
                kernel_lib._loaded.pop(lib, None)
            else:
                kernel_lib._loaded[lib] = v


def phase_sass(dev, args, first=None):
    os.makedirs(args.sass_dir, exist_ok=True)
    designs = {"port": os.path.join(ROOT, "stgraph_tpu_torch", "csrc")}
    if args.baseline_csrc:
        designs["first"] = args.baseline_csrc
    jobs = {f"{design}_{lib}": (os.path.join(d, f"{lib}.cu"), [])
            for design, d in designs.items() for lib in ("rowid_denom", "segment_max_wide")}
    jobs["k7_k5_parts"] = (os.path.join(HERE, "k7_k5_parts.cu"), [])
    for name, (path, log, secs) in k89.nvcc_many(jobs).items():
        inst = k89.ptxas_instances(log)
        names = k89.demangle([i[0] for i in inst])
        with open(os.path.join(args.sass_dir, f"{name}_instances.txt"), "w") as fh:
            for (_, regs, spill), nm in zip(inst, names):
                fh.write(f"{regs:4d} registers {spill:4d} B spilled  {nm}\n")
        record(phase="sass", library=name, nvcc_s=secs, instances=len(inst),
               registers={nm: regs for (_, regs, _), nm in zip(inst, names)},
               spilling=[f"{nm} {sp} B" for (_, _, sp), nm in zip(inst, names) if sp])


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="parts,check,turns,spans,variants,sass", help="comma-separated phases")
    ap.add_argument("--baseline-csrc", help="a directory with the first design's rowid_denom.cu and "
                                            "segment_max_wide.cu (parts, turns, sass)")
    ap.add_argument("--variants", default=",".join(["plan"] + list(VARIANTS)),
                    help="comma-separated builds of the variants phase (plan: K7's plan design)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the measurements as JSON here")
    ap.add_argument("--sass-dir", default=os.path.join(ROOT, "chiprun_out", "k7_k5_sass"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_k5_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    phases = args.only.split(",")
    first = First(args.baseline_csrc) if {"parts", "turns", "variants"} & set(phases) else None
    status = 0
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as data_dir:
        args.data_dir = data_dir
        for name in phases:
            t = time.perf_counter()
            try:
                globals()[f"phase_{name}"](dev, args, first)
            except Exception:  # a phase that fails does not take the others' numbers with it
                print(f"k7_k5_bench: {name} FAILED:\n{traceback.format_exc()}", flush=True)
                status = 1
            torch.cuda.empty_cache()
            print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
            if args.out:
                os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
                with open(args.out, "w") as fh:
                    json.dump({"device": smi, "results": kb.RESULTS}, fh, indent=1)
    print(smi)
    return status


if __name__ == "__main__":
    sys.exit(main())
