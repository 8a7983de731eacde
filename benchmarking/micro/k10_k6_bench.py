#!/usr/bin/env python3
"""Time K10 (the blocked multi-head segment sum) and K6 (the row-id SpMM)
of the PyTorch/CUDA port on one NVIDIA GPU, with their parts apart, at the
main paths' shapes of ``chip_smoke.py``:

- K10 at a PPI training step's shapes (4 x 256 and 6 x 121 on the forward
  and transpose blocked layouts of the PPI-sized graph, and 17 x 8, a
  narrow-head tiling whose heads leave most of a warp's lanes idle) and at
  the composed ogbn request's layers (4 x 256 and 6 x 47 on the synthetic
  ogbn-products graph);
- K6 at the dyn-step shape (the lazy pair after ``bench_dyn``'s 64 steps,
  F = 128).

Inputs are random from a seed (a kernel's time does not depend on the
values). For each shape it times the port's kernel, ``torch.zeros`` of the
output alone (what a kernel that zeroes its output first would add), the
plain version and the library yardsticks: for K10 one ``torch.sparse.mm``
over the block-diagonal-by-head pattern and the sum of H per-head calls;
for K6 one ``sparse.mm`` over a CSR of the store's live slots. On the PPI
graph it also times K1 at one head with an f32 stream at F = 1024 (the
same gathered bytes on K1's row-wise design) and K1's heads mode at 32 x 4
beside its single-call yardstick. Every kernel output is held against its
plain version before it is timed. ``--only composed`` times composed-
serving's request on the ogbn graph (host wall, device time, allocator
traffic and a profile of its host time).

    python3 benchmarking/micro/k10_k6_bench.py [--only ppi,dyn,ogbn,composed] [--out PATH]

It prints one line per measurement and, last, the card's name and power
limit; ``--out`` writes every number as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the graphs, bounds, timers and yardsticks of the smoke run)

RESULTS = []


def record(**kw):
    RESULTS.append(kw)
    print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in kw.items()), flush=True)


def agree(out, ref, mass, rows=1 << 18):
    """Worst |out - ref| over the terms' mass, taken ``rows`` rows at a time
    (an ogbn-products output is 10 GB)."""
    worst = 0.0
    for r0 in range(0, out.shape[0], rows):
        err = (out[r0:r0 + rows] - ref[r0:r0 + rows]).abs()
        worst = max(worst, cs._err_over_mass(err, mass[r0:r0 + rows]))
    return worst


def bench_k10(where, csr, blk, h, f, gen, iters):
    from stgraph_tpu_torch.ops.spmm_blocked import positions_in, segment_sum_blocked, segment_sum_blocked_plain

    n = csr.num_nodes
    e = csr.num_edges
    dev = csr.device
    x = torch.randn(n, h * f, device=dev, generator=gen)
    w = torch.rand(csr.capacity, h, device=dev, generator=gen)
    wb = w.index_select(0, positions_in(csr, blk.eids))
    b = cs.k10_bound(n, e, blk.capacity, h, f)
    row = dict(kernel="K10", where=where, H=h, F=f, N=n, E=e, CB=blk.capacity, bound_ms=b[0])
    ref = segment_sum_blocked_plain(blk, wb, x, h, cs.COMPOSED_PLAIN_EDGE_BLOCK)
    mass = segment_sum_blocked_plain(blk, wb.abs(), x.abs(), h, cs.COMPOSED_PLAIN_EDGE_BLOCK)
    row["plain_ms"] = cs.cuda_ms(lambda: segment_sum_blocked_plain(blk, wb, x, h, cs.COMPOSED_PLAIN_EDGE_BLOCK),
                                 iters=1, warmup=0)
    row["zeros_ms"] = cs.cuda_ms(lambda: torch.zeros(n, h * f, device=dev), iters)
    out = segment_sum_blocked(blk, wb, x, h)
    torch.cuda.synchronize()
    row["err"] = agree(out, ref, mass)
    del out, ref, mass
    row["ms"] = cs.cuda_ms(lambda: segment_sum_blocked(blk, wb, x, h), iters)
    row["library_ms"] = cs._library_blockdiag_ms(csr, w, x, h, e)
    row["library_heads_ms"] = cs._library_multihead_ms(csr, w, x, h, e)
    record(**row)
    return row


def phase_ppi(dev, args):
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_plain

    graph = cs.ppi_graph(dev, args.seed)[0]
    csr, csr_t = graph.fwd_csr, graph.bwd_csr
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    with torch.inference_mode():
        for name, c, blk in (("ppi forward", csr, graph.blocked_fwd), ("ppi transpose", csr_t, graph.blocked_bwd)):
            # the PPI step's two tilings, and a narrow-head one (the composed route's blocked branch
            # past 16 heads), whose heads leave most lanes idle
            for h, f in ((cs.PPI_HEADS[0], cs.PPI_HIDDEN), (cs.PPI_HEADS[-1], cs.PPI_CLASSES), (17, 8)):
                bench_k10(name, c, blk, h, f, gen, iters=20)
        # K1, one head, f32 stream, at F = 1024: the bytes K10 gathers at 4 x 256, on K1's design
        n, e = csr.num_nodes, csr.num_edges
        x = torch.randn(n, 1024, device=dev, generator=gen)
        w = torch.rand(csr.capacity, device=dev, generator=gen)
        out = spmm_rowmask(csr, w, x, stream_dtype=torch.float32)[0]
        err = agree(out, spmm_rowmask_plain(csr, w, x, torch.float32), spmm_rowmask_plain(csr, w, x.abs(),
                                                                                          torch.float32))
        record(kernel="K1", where="ppi forward", H=1, F=1024, stream="f32", err=err,
               ms=cs.cuda_ms(lambda: spmm_rowmask(csr, w, x, stream_dtype=torch.float32), iters=20),
               bound_ms=cs.k1_bound(n, e, 1024, True)[0])
        del x, w, out
        # K1's heads mode at rowmask-ppi's 32 x 4 (bf16 stream) and its single-call yardstick (f32)
        h, f = cs.ROWMASK_PPI_TILING
        fs = torch.randn(n, h * f, device=dev, generator=gen)
        w = torch.rand(csr.capacity, h, device=dev, generator=gen)
        record(kernel="K1 heads", where="ppi forward", H=h, F=f, stream="bf16",
               ms=cs.cuda_ms(lambda: spmm_rowmask(csr, w, fs, heads=h, with_denom=True,
                                                  stream_dtype=torch.bfloat16), iters=20),
               library_ms=cs._library_blockdiag_ms(csr, w, fs, h, e),
               library_heads_ms=cs._library_multihead_ms(csr, w, fs, h, e))


_OGBN = {}


def ogbn_graph(dev, args):
    """The synthetic ogbn-products graph and features of ``chip_smoke.py``,
    built once a run."""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph

    if not _OGBN:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as workdir:
            data = OgbNodeDataLoader(root=workdir, scale=args.scale, seed=args.seed)
            _OGBN["graph"] = StaticGraph(data.get_edges(), None, data.gdata["num_nodes"], device=dev)
            _OGBN["feats"] = torch.from_numpy(data.get_all_features()).to(dev)
            del data
        _ = _OGBN["graph"].blocked_fwd
        torch.cuda.synchronize()
        print(f"ogbn graph and blocked layout: {time.perf_counter() - t:.1f} s")
    return _OGBN["graph"], _OGBN["feats"]


def phase_ogbn(dev, args):
    graph, _ = ogbn_graph(dev, args)
    blk = graph.blocked_fwd
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    with torch.inference_mode():
        # composed-serving's first two layers (4 x 256) and its output layer (6 x 47)
        for h, f in ((cs.PPI_HEADS[0], cs.PPI_HIDDEN), (cs.PPI_HEADS[-1], cs.OGBN_CLASSES)):
            bench_k10("ogbn forward", graph.fwd_csr, blk, h, f, gen, iters=3)


def phase_dyn(dev, args):
    from stgraph_tpu_torch.ops import rowid_kernels as RK

    dyn = cs.phase_dyn_step(dev, args.seed)
    st, feats = dyn["pair"].fwd, dyn["feats"]
    n, f = feats.shape
    rows, cols, w = st.rows, st.cols, st.w
    live = int(((rows < n) & (w > 0)).sum())
    b = cs.rowid_bounds(rows.numel(), n, f, live)[0]
    row = dict(kernel="K6", where="dyn-step", F=f, N=n, slots=rows.numel(), live=live, bound_ms=b[0])
    with torch.inference_mode():
        ref = RK.spmm_rowid_plain(rows, cols, w, feats, n, cs.ROWID_PLAIN_EDGE_BLOCK)
        mass = RK.spmm_rowid_plain(rows, cols, w.abs(), feats.abs(), n, cs.ROWID_PLAIN_EDGE_BLOCK)
        row["plain_ms"] = cs.cuda_ms(lambda: RK.spmm_rowid_plain(rows, cols, w, feats, n, cs.ROWID_PLAIN_EDGE_BLOCK),
                                     iters=1)
        row["zeros_ms"] = cs.cuda_ms(lambda: torch.zeros(n, f, device=dev), 20)
        row["err"] = agree(RK.spmm_rowid(rows, cols, w, feats, n), ref, mass)
        row["ms"] = cs.cuda_ms(lambda: RK.spmm_rowid(rows, cols, w, feats, n), 20)
        sel = (rows < n) & (w > 0)
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(rows[sel].long(), minlength=n), 0)
        a = torch.sparse_csr_tensor(crow, cols[sel].long(), w[sel], size=(n, n), check_invariants=False)
        row["library err"] = agree(torch.sparse.mm(a, feats), ref, mass)
        row["library_ms"] = cs.cuda_ms(lambda: torch.sparse.mm(a, feats), 20)
    record(**row)


def phase_composed(dev, args):
    """Composed-serving's request (the GAT paper's PPI widths on the ogbn
    graph behind a ``Predictor``, as ``chip_smoke.py`` serves it): per
    request the host wall time, the device time between CUDA events around
    it, and the caching allocator's device allocations, frees and retries
    (``torch.cuda.memory_stats``)."""
    from stgraph_tpu_torch.serve import Predictor

    graph, feats = ogbn_graph(dev, args)
    dims = (cs.OGBN_FEATS, cs.PPI_HIDDEN, cs.OGBN_CLASSES)
    model = cs.build_gat(graph, "auto", dev, args.seed, dims, cs.PPI_HEADS)
    predictor = Predictor.build(model, dict(model.state_dict()), (feats,), device=dev)
    keys = ("num_device_alloc", "num_device_free", "num_alloc_retries")
    for r in range(4):
        stats = torch.cuda.memory_stats()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        out = predictor(feats)
        stop.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        after = torch.cuda.memory_stats()
        record(kernel="composed request", request=r, wall_ms=wall, device_ms=start.elapsed_time(stop),
               **{k: after.get(k, 0) - stats.get(k, 0) for k in keys})
        del out
    # where the host's time goes: the CPU operators by their own time, and
    # how long the device waits for its first and after its last activity
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        predictor(feats)
        torch.cuda.synchronize()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    gpu = [e for e in events if e.device_type == DeviceType.CUDA]
    t0, t1 = min(e.time_range.start for e in cpu), max(e.time_range.end for e in cpu)
    if gpu:
        record(kernel="composed request trace", window_ms=(t1 - t0) / 1e3,
               before_first_device_ms=(min(e.time_range.start for e in gpu) - t0) / 1e3,
               after_last_device_ms=(t1 - max(e.time_range.end for e in gpu)) / 1e3)
    for e in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]:
        record(kernel="composed request cpu op", name=e.key[:80], self_cpu_ms=e.self_cpu_time_total / 1e3,
               count=e.count)
    del predictor, model


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="ppi,dyn,ogbn", help="comma-separated phases: ppi, dyn, ogbn, composed")
    ap.add_argument("--scale", type=float, default=1.0, help="synthetic ogbn-products scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the measurements as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k10_k6_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    phases = {"ppi": phase_ppi, "dyn": phase_dyn, "ogbn": phase_ogbn, "composed": phase_composed}
    for name in args.only.split(","):
        t = time.perf_counter()
        phases[name](dev, args)
        torch.cuda.empty_cache()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "results": RESULTS}, fh, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
