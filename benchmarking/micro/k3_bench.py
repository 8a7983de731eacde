#!/usr/bin/env python3
"""Time K3 (the narrow segment sum) of the PyTorch/CUDA port on one NVIDIA
GPU, with its parts apart, at every shape of ``chip_smoke.py``'s main paths
that launches it:

- the PPI-sized graph (56,944 nodes, 818,716 edges) at K = 4 and 6 on the
  forward CSR (the softmax denominators and d er) and on the transpose CSR
  (d el): a PPI training step's nine launches;
- the synthetic ogbn-products graph (123,718,280 edges) at K = 4 on the
  forward CSR: the composed request's three launches.

Phases (``--only``):

- ``synthesis``: the synthetic ogbn-products graph made twice on the host,
  its CDF lookups by ``np.searchsorted`` (the loader before the native
  lookup) and by ``native.searchsorted_left``; host seconds of each and
  whether the arrays are equal.
- ``parts``: the first design's parts, built from ``--baseline-csrc`` (a copy
  of the first design's ``segment_sum_narrow.cu``): the wrapper's call as
  the path made it (CUDA events, back to back) and its host time alone (the
  host's seconds to issue a call, no wait), its ``index_fill_``, the kernel
  alone, and ``k3_parts.cu``'s probes: the item chain alone (no value read)
  and the value stream alone (each item's bounds at hand); each also as
  device time and launches by ``torch.profiler``.
- ``check``: the port's K3 at every shape into NaN-poisoned outputs against
  its plain version, two calls bit-equal, the tickets back at 0, one
  launch a call by the profiler.
- ``turns``: the first design and the port, each through its whole wrapper
  as the path calls it, timed in turns (first, port, port, first) at every
  shape, with each call's device time and launches by the profiler, its
  host time, the bound and ``segment_reduce``.
- ``chunks``: the port's K3 at items of 128, 256, 512 and 1024 edges, swept
  up then down, at every shape.
- ``variants``: edited copies of the port's source (``VARIANTS``: 4, 16
  and 32 lanes an item, half and twice the edges in flight and K4's at
  K = 3 and 4, at least six
  blocks an SM, the split rows' final sum left out) and the source on its
  items in row order (``PLAN_VARIANTS``), through the wrapper at every
  shape and each of ``--variant-chunks``, in turns (each build, then again
  in reverse), with device times.
- ``sass``: the port's and the first design's K3 and the probes built side
  by side with ``-Xptxas -v``: registers and spills of every instance.

    python3 benchmarking/micro/k3_bench.py [--only synthesis,parts,check,turns,chunks,variants,sass]
        [--baseline-csrc DIR] [--scale S] [--out PATH] [--sass-dir DIR]

Inputs are random from a seed (a kernel's time does not depend on the
values). It prints one line per measurement and, last, the card's name and
power limit; ``--out`` writes every number as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
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
import k8_k9_bench as k89  # noqa: E402  (parallel nvcc builds, ptxas parsing)

_VP, _I = ctypes.c_void_p, ctypes.c_int
FIRST_CHUNK = 1024  # the first design's items
FIRST_K3 = [_VP, _VP, _VP, _VP, _I, _VP, _I, _I, _VP]
PROBE_K3 = [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _I, _VP]
record = kb.record


def device_profile(fn, calls=20):
    """One call of ``fn`` on the device, by the profiler over ``calls``
    calls: its device ms (the mean of each kernel's events, summed over the
    kernels a call launches), the kernels' events seen a call, and their
    names. At 0.9 ms a call the profiler has dropped about one call in five
    (0.8 events a call where the wrapper launches one), so the device time
    is taken a launch, not over the calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name.setdefault(ev.name, []).append(ev.time_range.elapsed_us() / 1e3)
    ms = sum(sum(t) / len(t) for t in by_name.values())
    return ms, sum(len(t) for t in by_name.values()) / calls, sorted(by_name)


def stream():
    return torch.cuda.current_stream().cuda_stream


class First:
    """K3's first design, built from ``--baseline-csrc``, called as its
    wrapper called it (1024-edge items, split rows zeroed by ``index_fill_``),
    and its probes (``k3_parts.cu``)."""

    def __init__(self, csrc):
        jobs = {"k3_parts": (os.path.join(HERE, "k3_parts.cu"), [])}
        if csrc:
            jobs["first_k3"] = (os.path.join(csrc, "segment_sum_narrow.cu"), [])
        self.libs = {}
        for name, (path, _, _) in k89.nvcc_many(jobs).items():
            lib = ctypes.CDLL(path)
            for fn, argtypes in (("stg_segment_sum_narrow", FIRST_K3), ("stg_k3_probe", PROBE_K3)):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            self.libs[name] = lib
        self.bounds = {}

    @staticmethod
    def items(csr):
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        return _work_items(csr, FIRST_CHUNK)

    def kernel(self, csr, plane, out):
        item_row, item_beg, _ = self.items(csr)
        rc = self.libs["first_k3"].stg_segment_sum_narrow(
            csr.indptr.data_ptr(), plane.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(),
            out.data_ptr(), plane.shape[1], FIRST_CHUNK, stream())
        assert rc == 0, rc

    def call(self, csr, vals):
        """The first wrapper: the plane, the output, the split rows zeroed,
        the kernel."""
        plane = vals.to(torch.float32).contiguous()
        out = torch.empty(csr.num_nodes, plane.shape[1], dtype=torch.float32, device=vals.device)
        split = self.items(csr)[2]
        if split.numel():
            out.index_fill_(0, split, 0.0)
        self.kernel(csr, plane, out)
        return out

    def probe(self, csr, plane, out, phase):
        item_row, item_beg, _ = self.items(csr)
        bounds = self.bounds.get(id(csr))
        if bounds is None:  # each item's (row, first edge, end, split), made once
            indptr = csr.host_arrays()[0].astype(np.int64)
            row = item_row.cpu().numpy().astype(np.int64)
            beg = item_beg.cpu().numpy().astype(np.int64)
            end = np.minimum(beg + FIRST_CHUNK, indptr[1:][row])
            split = np.diff(indptr)[row] > FIRST_CHUNK
            bounds = torch.from_numpy(np.stack([row, beg, end, split], 1).astype(np.int32)).to(csr.device)
            self.bounds[id(csr)] = bounds
        rc = self.libs["k3_parts"].stg_k3_probe(
            csr.indptr.data_ptr(), plane.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(), bounds.data_ptr(),
            item_row.numel(), out.data_ptr(), plane.shape[1], FIRST_CHUNK, phase, stream())
        assert rc == 0, rc


_GRAPHS = {}


def ogbn_graph(dev, args):
    """``chip_smoke.py``'s synthetic ogbn-products graph (``_synthesize`` at
    ``--scale``, the forward CSR), built once a run."""
    from stgraph_tpu_torch.dataset import ogb_dataloader as O
    from stgraph_tpu_torch.graph import StaticGraph

    if "ogbn" not in _GRAPHS:
        edge_index = _GRAPHS.pop("ogbn_edges", None)
        if edge_index is None:
            edge_index = O.OgbNodeDataLoader._synthesize(*O.OGBN_PRODUCTS_STATS, scale=args.scale,
                                                         seed=args.seed)[0]
        n = max(int(O.OGBN_PRODUCTS_STATS[0] * args.scale), 64)  # the loader's node count
        t = time.perf_counter()
        _GRAPHS["ogbn"] = StaticGraph(edge_index.T, None, n, device=dev)
        torch.cuda.synchronize()
        record(phase="graph", graph="ogbn", N=n, E=_GRAPHS["ogbn"].fwd_csr.num_edges,
               build_s=time.perf_counter() - t)
    return _GRAPHS["ogbn"]


def shapes(dev, args, gen, only=None):
    """(label, csr, vals) of every K3 shape of the main paths: PPI at K = 4
    and 6 on both CSRs, ogbn at K = 4 on the forward CSR; random positive
    values (the denominators' weights)."""
    if "ppi" not in _GRAPHS:
        _GRAPHS["ppi"] = cs.ppi_graph(dev, args.seed)[0]
    ppi = _GRAPHS["ppi"]
    cases = [(f"ppi {name} K={k}", csr, k) for name, csr in (("forward", ppi.fwd_csr), ("transpose", ppi.bwd_csr))
             for k in sorted({cs.PPI_HEADS[0], cs.PPI_HEADS[-1]})]
    if not args.no_ogbn:
        cases.append(("ogbn forward K=4", None, 4))
    for label, csr, k in cases:
        if only is not None and not label.startswith(only):
            continue
        if csr is None:
            csr = ogbn_graph(dev, args).fwd_csr
        yield label, csr, torch.rand(csr.capacity, k, device=dev, generator=gen)


def iters(csr):
    return 20 if csr.num_edges > 10_000_000 else 200


def host_ms(fn, calls):
    """The host's ms to issue one call of ``fn`` (no wait on the card)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def plain(csr, vals):
    from stgraph_tpu_torch.ops.segment_kernels import segment_sum_narrow_plain

    return segment_sum_narrow_plain(csr, vals, 1 << 24)


def agreement(out, csr, vals):
    return cs.k3_agreement(out, csr, vals, 1 << 24)[1]


def phase_synthesis(dev, args, first=None):
    from stgraph_tpu_torch.dataset import ogb_dataloader as O

    stats = O.OGBN_PRODUCTS_STATS
    t = time.perf_counter()
    new = O.OgbNodeDataLoader._synthesize(*stats, scale=args.scale, seed=args.seed)
    native_s = time.perf_counter() - t
    saved = O._lookup
    O._lookup = lambda cdf, x: np.searchsorted(cdf, x)  # the loader before the native lookup
    try:
        t = time.perf_counter()
        old = O.OgbNodeDataLoader._synthesize(*stats, scale=args.scale, seed=args.seed)
        numpy_s = time.perf_counter() - t
    finally:
        O._lookup = saved
    equal = all(np.array_equal(a, b) for a, b in zip(new, old))
    del old
    cpus = len(os.sched_getaffinity(0))
    record(phase="synthesis", scale=args.scale, E=new[0].shape[1], numpy_s=numpy_s, native_s=native_s,
           arrays_equal=equal, host_cpus=cpus)
    cs.check(equal, "the native lookups changed the synthetic graph")
    _GRAPHS["ogbn_edges"] = new[0]


def phase_parts(dev, args, first):
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    with torch.inference_mode():
        for label, csr, vals in shapes(dev, args, gen):
            n, e, k = csr.num_nodes, csr.num_edges, vals.shape[1]
            split = first.items(csr)[2]
            out = torch.empty(n, k, device=dev)
            row = dict(phase="parts", shape=label, N=n, E=e, K=k, split_rows_1024=split.numel(),
                       longest_row=int(np.diff(csr.host_arrays()[0].astype(np.int64)).max()))
            row["err_first"] = agreement(first.call(csr, vals), csr, vals)
            out.index_fill_(0, split, 0.0)
            first.probe(csr, vals, out, 0)
            row["err_probe_whole"] = agreement(out, csr, vals)
            it = iters(csr)
            calls = {
                "call": lambda: first.call(csr, vals),
                "kernel": lambda: first.kernel(csr, vals, out),
                "index_fill": lambda: out.index_fill_(0, split, 0.0),
                "item_chain_alone": lambda: first.probe(csr, vals, out, 1),
                "value_stream_alone": lambda: first.probe(csr, vals, out, 2),
            }
            for key, fn in calls.items():
                row[f"{key}_ms"] = cs.cuda_ms(fn, it, warmup=3)
                dev_ms, launches, names = device_profile(fn)
                row[f"{key}_device_ms"] = dev_ms
                row[f"{key}_launches"] = launches
            row["call_kernels"] = device_profile(calls["call"])[2]
            row["call_host_ms"] = host_ms(calls["call"], it)
            b = cs.k3_bound(n, e, k)
            row["bound_ms"], row["bound_by"] = b[0], b[1]
            row["library_ms"] = cs._library_segment_sum_ms(csr, vals, e)
            record(**row)


def _tickets(csr, k):
    from stgraph_tpu_torch.ops import segment_kernels as SEG

    return SEG._k3_plan(csr, SEG.K3_CHUNK, k)[2]


def phase_check(dev, args, first=None):
    from stgraph_tpu_torch.ops.segment_kernels import segment_sum_narrow

    gen = torch.Generator(device=dev).manual_seed(args.seed + 37)
    with torch.inference_mode():
        for label, csr, vals in shapes(dev, args, gen):
            n, k = csr.num_nodes, vals.shape[1]
            segment_sum_narrow(csr, vals)  # the plan, built once
            a = cs.poisoned_call((n, k), lambda: segment_sum_narrow(csr, vals))
            b = cs.poisoned_call((n, k), lambda: segment_sum_narrow(csr, vals))
            err = agreement(a, csr, vals)
            tickets = _tickets(csr, k)
            _, launches, names = device_profile(lambda: segment_sum_narrow(csr, vals))
            seen = {c: device_profile(lambda: segment_sum_narrow(csr, vals), c)[1] for c in (1, 5, 20)}
            launches = max(launches, *seen.values())  # the profiler may drop events, never add them
            ok = err <= cs.KERNEL_TOL and bool(torch.equal(a, b)) and not tickets.any().item() and launches == 1
            record(phase="check", shape=label, err_over_mass=err, bit_equal_two_calls=bool(torch.equal(a, b)),
                   tickets_zero=not tickets.any().item(), launches_per_call=launches, kernels=names,
                   events_a_call_by_session_calls=seen,
                   split_rows=tickets.numel(), ok=ok)
            cs.check(ok, f"K3 at {label} disagrees, differs between calls, leaves a ticket or launches {launches}")


def phase_turns(dev, args, first):
    from stgraph_tpu_torch.ops.segment_kernels import segment_sum_narrow

    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    with torch.inference_mode():
        for label, csr, vals in shapes(dev, args, gen):
            n, e, k = csr.num_nodes, csr.num_edges, vals.shape[1]
            new = lambda: segment_sum_narrow(csr, vals)  # noqa: E731
            old = lambda: first.call(csr, vals)  # noqa: E731
            new()
            err_new = agreement(cs.poisoned_call((n, k), new), csr, vals)
            err_first = agreement(old(), csr, vals)
            cs.check(err_new <= cs.KERNEL_TOL, f"K3 at {label} disagrees with its plain version: {err_new}")
            (o1, o2), (n1, n2) = kb._turns(old, new, iters(csr))
            fd, nd = device_profile(old), device_profile(new)
            b = cs.k3_bound(n, e, k)
            record(phase="turns", shape=label, N=n, E=e, K=k, first_ms=[o1, o2], new_ms=[n1, n2],
                   first_device_ms=fd[0], first_launches=fd[1], first_kernels=fd[2], new_device_ms=nd[0],
                   new_launches=nd[1], new_kernels=nd[2], first_host_ms=host_ms(old, iters(csr)),
                   new_host_ms=host_ms(new, iters(csr)), err_first=err_first, err_new=err_new, bound_ms=b[0],
                   bound_by=b[1], library_ms=cs._library_segment_sum_ms(csr, vals, e))


def phase_chunks(dev, args, first=None):
    from stgraph_tpu_torch.ops import segment_kernels as SEG

    saved = SEG.K3_CHUNK
    gen = torch.Generator(device=dev).manual_seed(args.seed + 43)
    try:
        with torch.inference_mode():
            for label, csr, vals in shapes(dev, args, gen):
                for chunk in (128, 256, 512, 1024, 1024, 512, 256, 128):
                    SEG.K3_CHUNK = chunk
                    fn = lambda: SEG.segment_sum_narrow(csr, vals)  # noqa: E731
                    record(phase="chunks", shape=label, chunk=chunk, ms=cs.cuda_ms(fn, iters(csr), warmup=3),
                           device_ms=device_profile(fn)[0])
    finally:
        SEG.K3_CHUNK = saved


K3_SRC = "segment_sum_narrow.cu"
K3_L = "constexpr int kL = 8;  // lanes a work item"
K3_U = "return k <= 4 ? 8 : (k <= 8 ? 4 : 2);"
K3_BOUNDS = "__global__ void __launch_bounds__(kWarpsPerBlock * 32)\nsegment_sum_narrow_kernel("
# The port's K3 taken apart: edits of a copy of csrc/segment_sum_narrow.cu
VARIANTS = {
    "source": (),
    "lanes_4": ((K3_L, "constexpr int kL = 4;"),),
    "lanes_16": ((K3_L, "constexpr int kL = 16;"),),
    "lanes_32": ((K3_L, "constexpr int kL = 32;"),),
    "u_half": ((K3_U, "return k <= 4 ? 4 : (k <= 8 ? 2 : 1);"),),
    "u_double": ((K3_U, "return k <= 4 ? 16 : (k <= 8 ? 8 : 4);"),),
    "u_4_at_k4": ((K3_U, "return k <= 2 ? 8 : (k <= 8 ? 4 : 2);"),),  # K4's edges in flight at K = 3, 4
    # at least 6 blocks an SM: 40 registers a thread at most
    "min_blocks_6": ((K3_BOUNDS, "__global__ void __launch_bounds__(kWarpsPerBlock * 32, 6)\n"
                                 "segment_sum_narrow_kernel("),),
    # the split rows' final sum left out (wrong sums: timing only)
    "no_final_sum": (("const int parts = last ? sp.y : 0;", "const int parts = 0;"),),
}
# the source's build on another plan: its items in row order (the split
# rows' items where their rows fall, not first)
PLAN_VARIANTS = {"rows_in_order": "source"}


def _rows_in_order(plan):
    items = plan[0]
    code = items[:, 0].long()
    order = torch.argsort(torch.where(code < 0, ~code, code), stable=True)
    return (items[order].contiguous(),) + tuple(plan[1:])


def phase_variants(dev, args, first=None):
    from stgraph_tpu_torch.ops import kernel_lib
    from stgraph_tpu_torch.ops import segment_kernels as SEG

    csrc = os.path.join(ROOT, "stgraph_tpu_torch", "csrc")
    names = [n for n in args.variants.split(",") if n in VARIANTS or n in PLAN_VARIANTS]
    with open(os.path.join(csrc, K3_SRC)) as fh:
        source = fh.read()
    jobs = {}
    for name in {PLAN_VARIANTS.get(n, n) for n in names}:
        text = source
        for old, new in VARIANTS[name]:
            assert old in text, (name, old)
            text = text.replace(old, new)
        d = os.path.join(k89.BUILD_DIR, f"k3_variant_{name}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, K3_SRC), "w") as fh:
            fh.write(text)
        jobs[name] = (os.path.join(d, K3_SRC), [])
    libs = {}
    for name, (path, log, _) in k89.nvcc_many(jobs).items():
        inst = k89.ptxas_instances(log)
        record(phase="variants", library=name, registers=[i[1] for i in inst], spilled=[i[2] for i in inst])
        lib = ctypes.CDLL(path)
        for fn, sig in SEG._K3_SIGNATURES.items():
            getattr(lib, fn).argtypes = sig
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    saved = kernel_lib._loaded.get("segment_sum_narrow")
    saved_chunk = SEG.K3_CHUNK
    gen = torch.Generator(device=dev).manual_seed(args.seed + 47)
    try:
        with torch.inference_mode():
            cases = list(shapes(dev, args, gen))
            for chunk in [int(c) for c in args.variant_chunks.split(",")]:
                SEG.K3_CHUNK = chunk
                times = {}
                for variant in names + names[::-1]:
                    kernel_lib._loaded["segment_sum_narrow"] = libs[PLAN_VARIANTS.get(variant, variant)]
                    for label, csr, vals in cases:
                        fn = lambda c=csr, v=vals: SEG.segment_sum_narrow(c, v)  # noqa: E731
                        fn()  # the plan, built once
                        key = f"k3_items_{chunk}"
                        plan = csr._cache[key]
                        if variant in PLAN_VARIANTS:
                            csr._cache[key] = _rows_in_order(plan)
                        try:
                            times.setdefault(f"{label}:{variant}", []).append(round(cs.cuda_ms(fn, 50, warmup=3), 5))
                            times.setdefault(f"{label}:{variant}:device", []).append(round(device_profile(fn)[0], 5))
                        finally:
                            csr._cache[key] = plan
                record(phase="variants", chunk=chunk, **times)
    finally:
        SEG.K3_CHUNK = saved_chunk
        if saved is None:
            kernel_lib._loaded.pop("segment_sum_narrow", None)
        else:
            kernel_lib._loaded["segment_sum_narrow"] = saved


def phase_sass(dev, args, first=None):
    os.makedirs(args.sass_dir, exist_ok=True)
    jobs = {"port_segment_sum_narrow": (os.path.join(ROOT, "stgraph_tpu_torch", "csrc", K3_SRC), []),
            "k3_parts": (os.path.join(HERE, "k3_parts.cu"), [])}
    if args.baseline_csrc:
        jobs["first_segment_sum_narrow"] = (os.path.join(args.baseline_csrc, K3_SRC), [])
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
    ap.add_argument("--only", default="parts,check,turns,chunks,variants,sass", help="comma-separated phases")
    ap.add_argument("--baseline-csrc", help="a directory with the first design's segment_sum_narrow.cu "
                                            "(parts, turns, sass)")
    ap.add_argument("--variants", default=",".join(list(VARIANTS) + list(PLAN_VARIANTS)),
                    help="comma-separated builds of the variants phase")
    ap.add_argument("--variant-chunks", default="256", help="comma-separated item lengths of the variants phase")
    ap.add_argument("--scale", type=float, default=1.0, help="synthetic ogbn-products scale")
    ap.add_argument("--no-ogbn", action="store_true", help="the PPI shapes alone")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the measurements as JSON here")
    ap.add_argument("--sass-dir", default=os.path.join(ROOT, "chiprun_out", "k3_sass"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    phases = args.only.split(",")
    first = First(args.baseline_csrc) if {"parts", "turns"} & set(phases) else None
    status = 0
    for name in phases:
        t = time.perf_counter()
        try:
            globals()[f"phase_{name}"](dev, args, first)
        except Exception:  # a phase that fails does not take the others' numbers with it
            print(f"k3_bench: {name} FAILED:\n{traceback.format_exc()}", flush=True)
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
