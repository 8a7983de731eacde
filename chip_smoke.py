#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stgraph_tpu_torch``) on one NVIDIA GPU.

Phases (any failure exits nonzero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit, the
   nvcc version, and the time to build every kernel from the sources;
2. K1 against its plain version on the card, at F in {47, 100, 128},
   weighted and unweighted, f32 and bf16 streams, on a graph with empty rows
   and one hub row;
3. serving, the main path: a 3-layer GCN (100 -> 128 -> 128 -> 47, ReLU
   between layers, random weights from ``--seed`` carried through
   ``convert.py``) behind a ``Predictor`` on the synthetic ogbn-products
   graph (``--scale 1.0``: 2,449,029 nodes, 123,718,280 edges, so K1
   streams bf16) answers 3 requests. The K1 launch count is
   set to 0 just before and read just after; it must grow by 3 a request.
   Each layer's output in the first request is held against the plain
   formula on 4096 sampled destination rows (and the largest hub);
4. K1 at the main path's shapes: the kernel, its plain version (in edge
   blocks, to bound memory) and ``torch.sparse.mm`` as a timed yardstick,
   with the full outputs compared;
5. the whole model at ``--scale 0.01`` against the plain torch path;
6. a profile of one request (informational).

The last two lines are the kernels JSON and ``{"ok": true, "device": ...}``.
``--details PATH`` also writes every measurement of the run as JSON.

    python3 chip_smoke.py [--scale 1.0] [--seed 0] [--details PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the f32 rate
# outside the tensor cores (K1's adds and multiplies run there).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Kernel vs plain version: the products are rounded alike (bf16 stream:
# features, weights and products in bf16); the plain version sums in f64,
# the kernel in f32 along at most ~2000 additions (1024 in a warp, then one
# atomicAdd per work item of a split row). The classical bound for that,
# (n - 1) * u * sum|terms| with u = 2^-24, is 1.2e-4 of each output's sum
# of absolute terms; every output element is held to 2e-4 of it.
KERNEL_TOL = 2e-4
# Whole model, kernel path (bf16 stream) vs the plain torch path (f32
# throughout): three roundings of 2^-9 per product, over three layers.
MODEL_TOL = 3e-2

GCN_DIMS = (100, 128, 128, 47)
REQUESTS = 3
SAMPLE_ROWS = 4096
PLAIN_EDGE_BLOCK = 1 << 24  # bounds the plain version's temporaries (~25 GB)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def k1_bound(n: int, e: int, f: int, weighted: bool):
    """Least time for one K1 call: indptr, cols, w and the f32 feature table
    read once, the f32 output written once, over HBM; or 2 (1 unweighted)
    f32 operations per edge and column over the f32 peak."""
    nbytes = (n + 1) * 4 + e * 4 + (e * 4 if weighted else 0) + n * f * 4 + n * f * 4
    ops = (2 if weighted else 1) * e * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k1_agreement(out, csr, w, x, stream, edge_block=None):
    """Hold K1's output against its plain version on the same inputs.
    Returns (max_abs_err, worst err / sum|terms| ratio, max |plain|)."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_plain

    ref = spmm_rowmask_plain(csr, w, x, stream, edge_block)
    err = (out - ref).abs()
    max_err, max_ref = err.max().item(), ref.abs().max().item()
    del ref
    absw = None if w is None else w.abs()
    mass = spmm_rowmask_plain(csr, absw, x.abs(), stream, edge_block)  # sum of |terms|
    ratio = (err / mass.clamp(min=1e-30)).masked_fill(err == 0, 0.0).max().item()
    return max_err, ratio, max_ref


def phase_environment(port):
    from stgraph_tpu_torch import native
    from stgraph_tpu_torch.ops import kernel_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [kernel_lib._nvcc(), "--version"], capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    logs = kernel_lib.build()
    check(native.available(), "the native CSR builder did not build")
    build_s = time.perf_counter() - t0
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, nvcc: {nvcc}")
    print(smi)
    print(f"build: kernels {sorted(kernel_lib.SOURCES)} + native CSR builder in {build_s:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    return {"nvidia_smi": smi, "nvcc": nvcc, "build_s": build_s}


def phase_k1_vs_plain(dev, rng):
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask

    n, e, empty, hub, hub_deg = 200_000, 4_000_000, 1000, 12_345, 300_000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - empty, e)
    dst[:hub_deg] = hub
    csr = build_csr(src, dst, n, device=dev)
    results, worst = [], 0.0
    for f in (47, 100, 128):
        x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.random(csr.capacity).astype(np.float32)).to(dev)
        for weighted in (False, True):
            for stream in (torch.float32, torch.bfloat16):
                ww = w if weighted else None
                out, _ = spmm_rowmask(csr, ww, x, stream_dtype=stream)
                torch.cuda.synchronize()
                err, ratio, max_ref = k1_agreement(out, csr, ww, x, stream)
                ok = ratio <= KERNEL_TOL and not out[n - empty:].any().item()
                tag = f"F={f} {'weighted' if weighted else 'unweighted'} {str(stream)[6:]} stream"
                print(f"k1-check {tag}: max_abs_err {err:.3e} (max |plain| {max_ref:.1f}), "
                      f"worst err/sum|terms| {ratio:.2e} (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"K1 disagrees with its plain version at {tag}")
                worst = max(worst, err)
                results.append({"case": tag, "max_abs_err": err, "err_over_mass": ratio,
                                "max_abs_plain": max_ref})
    return {"graph": {"n": n, "e": e, "empty_rows": empty, "hub_deg": hub_deg},
            "cases": results, "max_abs_err": worst}


class GCN(torch.nn.Module):
    """The served model: GCNConv layers over a fixed graph."""

    def __init__(self, graph, dims, impl, device):
        super().__init__()
        from stgraph_tpu_torch.nn import GCNConv

        self.graph = graph
        self.layers = torch.nn.ModuleList(
            GCNConv(a, b, activation=None if i == len(dims) - 2 else torch.relu, impl=impl, device=device)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
        )

    def forward(self, h):
        for layer in self.layers:
            h = layer(self.graph, h)
        return h


def numpy_gcn_params(dims, seed):
    """A flax-shaped GCN parameter tree (xavier-uniform weights, zero bias)
    made with numpy from ``seed``, as the JAX package would hand it over."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lim = np.sqrt(6.0 / (a + b))
        tree[f"GCNConv_{i}"] = {
            "weight": rng.uniform(-lim, lim, (a, b)).astype(np.float32),
            "bias": np.zeros(b, np.float32),
        }
    return {"params": tree}


def build_model(graph, impl, dev, seed):
    from stgraph_tpu_torch.convert import gcn_params_from_jax

    model = GCN(graph, GCN_DIMS, impl, dev)
    model.load_state_dict(gcn_params_from_jax(numpy_gcn_params(GCN_DIMS, seed)))
    return model.eval()


def sampled_layer_check(graph, layer, h_in, y, rows, relu):
    """Hold one layer's served output against the plain formula
    ``act(norm_d * sum_e bf16(bf16(hw[c]) * bf16(norm[c])) + b)`` on ``rows``,
    summed in f64. Returns (max_abs_err, worst err / (norm_d sum|terms|),
    max |ref|, edges checked)."""
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    csr = graph.fwd_csr
    indptr = csr.host_arrays()[0].astype(np.int64)
    deg = indptr[rows + 1] - indptr[rows]
    local = np.repeat(np.arange(len(rows)), deg)
    first = np.cumsum(deg) - deg
    eidx = indptr[rows][local] + (np.arange(deg.sum()) - first[local])
    dev = y.device
    cols = csr.cols[torch.from_numpy(eidx).to(dev)].long()
    norm = symmetric_norm(graph)
    hw = h_in @ layer.weight
    prod = hw[cols].to(torch.bfloat16).float() * norm[cols].to(torch.bfloat16).float()
    prod = prod.to(torch.bfloat16).double()
    local_t = torch.from_numpy(local).to(dev)
    zeros = torch.zeros(len(rows), hw.shape[1], dtype=torch.float64, device=dev)
    agg = zeros.index_add(0, local_t, prod)
    mass = zeros.index_add(0, local_t, prod.abs())
    norm_d = norm[torch.from_numpy(rows).to(dev)].double()
    ref = agg * norm_d + layer.bias.double()
    if relu:
        ref = torch.relu(ref)
    got = y[torch.from_numpy(rows).to(dev)].double()
    err = (got - ref).abs()
    ratio = (err / (mass * norm_d).clamp(min=1e-300)).masked_fill(err == 0, 0.0).max().item()
    return err.max().item(), ratio, ref.abs().max().item(), int(deg.sum())


def phase_serving(dev, args, workdir):
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask
    from stgraph_tpu_torch.serve import Predictor

    t0 = time.perf_counter()
    data = OgbNodeDataLoader(root=workdir, scale=args.scale, seed=args.seed)
    n = data.gdata["num_nodes"]
    t1 = time.perf_counter()
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    feats = torch.from_numpy(data.get_all_features()).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model = build_model(graph, "auto", dev, args.seed)
    predictor = Predictor.build(model, dict(model.state_dict()), (feats,), device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    e = graph.get_num_edges()
    print(f"serve setup: synthetic={data.synthetic} N={n} E={e}: data {t1 - t0:.2f} s, "
          f"graph build+upload {t2 - t1:.2f} s, model+Predictor.build (warm call) {t3 - t2:.2f} s")

    captured = []
    hooks = [
        layer.register_forward_hook(lambda mod, inp, out: captured.append((inp[1], out)))
        for layer in model.layers
    ]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    requests = [feats] + [
        feats + 0.1 * torch.randn(feats.shape, device=dev, generator=gen) for _ in range(REQUESTS - 1)
    ]
    torch.cuda.synchronize()
    times = []
    spmm_rowmask.launches = 0
    for r, x in enumerate(requests):
        before = spmm_rowmask.launches
        t = time.perf_counter()
        logits = predictor(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if r == 0:
            for h in hooks:
                h.remove()
        check(spmm_rowmask.launches - before == 3,
              f"request {r}: K1 launched {spmm_rowmask.launches - before} times, expected 3")
        check(tuple(logits.shape) == (n, GCN_DIMS[-1]), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all().item()), f"request {r}: non-finite logits")
    launches = spmm_rowmask.launches
    print(f"serve: {REQUESTS} requests, K1 launches {launches}, per-request s "
          f"{[round(t, 4) for t in times]}, logits finite, shape {tuple(logits.shape)}")

    rng = np.random.default_rng(args.seed + 1)
    deg = graph.in_degrees()
    rows = np.unique(np.concatenate([rng.choice(n, min(SAMPLE_ROWS, n), replace=False), [int(deg.argmax())]]))
    checks = []
    with torch.inference_mode():
        for i, (layer, (h_in, y)) in enumerate(zip(model.layers, captured)):
            err, ratio, max_ref, n_edges = sampled_layer_check(graph, layer, h_in, y, rows, relu=i < 2)
            # the f32 bias add and ReLU add one rounding of the output: u = 6e-8 of |ref|
            ok = ratio <= KERNEL_TOL or err <= 1e-6 * max(1.0, max_ref)
            print(f"serve-check layer {i} (F={layer.out_feats}): {len(rows)} rows incl. hub of "
                  f"degree {int(deg.max())}, {n_edges} edges: max_abs_err {err:.3e} (max |ref| "
                  f"{max_ref:.2f}), worst err/(norm*sum|terms|) {ratio:.2e} {'ok' if ok else 'FAIL'}")
            check(ok, f"layer {i} output disagrees with the plain formula")
            checks.append({"layer": i, "max_abs_err": err, "err_over_mass": ratio,
                           "max_abs_ref": max_ref, "rows": len(rows)})
    return {
        "graph": graph, "model": model, "predictor": predictor, "feats": feats,
        "inputs": [h for h, _ in captured], "launches": launches,
        "record": {
            "n": n, "e": e, "synthetic": data.synthetic, "scale": args.scale,
            "data_s": t1 - t0, "graph_s": t2 - t1, "build_s": t3 - t2,
            "request_s": times, "launches": launches, "sampled_checks": checks,
            "max_in_degree": int(deg.max()),
        },
    }


def phase_k1_at_main_shapes(served):
    from stgraph_tpu_torch.ops import message as M
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_plain
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    graph = served["graph"]
    csr = graph.fwd_csr
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    per_launch, worst = [], 0.0
    with torch.inference_mode():
        w = M.gather_src(csr, symmetric_norm(graph))  # the lowering's weight
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.cols[:e], w.reshape(-1)[:e], size=(n, n),
                                        check_invariants=False)
        for layer, h_in in zip(served["model"].layers, served["inputs"]):
            hw = h_in @ layer.weight
            f = hw.shape[1]
            bf16 = torch.bfloat16
            out, _ = spmm_rowmask(csr, w, hw, stream_dtype=bf16)
            torch.cuda.synchronize()
            err, ratio, max_ref = k1_agreement(out, csr, w, hw, bf16, PLAIN_EDGE_BLOCK)
            check(ratio <= KERNEL_TOL, f"K1 at F={f} (full graph) disagrees: err/sum|terms| {ratio}")
            del out
            ms = cuda_ms(lambda: spmm_rowmask(csr, w, hw, stream_dtype=bf16), iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: spmm_rowmask_plain(csr, w, hw, bf16, edge_block=PLAIN_EDGE_BLOCK),
                               iters=2, warmup=1)
            try:  # a timed yardstick only; the port never calls it
                lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, hw), iters=5, warmup=1)
            except RuntimeError as exc:
                print(f"library yardstick unavailable at F={f}: {exc}")
                lib_ms = None
            bound_ms, bound_by, nbytes, ops = k1_bound(n, e, f, weighted=True)
            print(f"k1-main F={f}: {ms:.3f} ms (plain {plain_ms:.1f} ms, torch.sparse.mm {lib_ms} ms, "
                  f"bound {bound_ms:.3f} ms by {bound_by}); full-graph max_abs_err {err:.3e} "
                  f"(max |plain| {max_ref:.2f}), worst err/sum|terms| {ratio:.2e}")
            worst = max(worst, err)
            per_launch.append({"F": f, "E": e, "N": n, "stream": "bf16", "weighted": True,
                               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                               "ops": ops, "max_abs_err": err, "err_over_mass": ratio})
    return per_launch, worst


def phase_model_vs_plain(dev, args, workdir):
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    x = torch.from_numpy(data.get_all_features()).to(dev)
    with torch.inference_mode():
        out_k = build_model(graph, "auto", dev, args.seed)(x)
        out_p = build_model(graph, "torch", dev, args.seed)(x)
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    ok = err <= MODEL_TOL * scale
    print(f"model-check scale 0.01 (N={n}, E={graph.get_num_edges()}): kernel path vs plain torch "
          f"path max_abs_err {err:.3e} (max |plain| {scale:.3f}, tol {MODEL_TOL:g} x that) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the served model disagrees with the plain path at scale 0.01")
    return {"n": n, "e": graph.get_num_edges(), "max_abs_err": err, "max_abs_plain": scale}


def phase_profile(served):
    """Device time by kernel over one request, and the device's idle share
    between the request's first and last kernel (informational)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predictor, feats = served["predictor"], served["feats"]
    predictor(feats)  # the profiler's own first-use cost stays out of the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        predictor(feats)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(len(kernels) > 0, "the profiler saw no device activity")
    by_name = {}
    for e in kernels:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy = sum(ms for ms, _ in by_name.values())
    span = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    rows = sorted(((ms, name, c) for name, (ms, c) in by_name.items()), reverse=True)
    print(f"profile: one request {wall_ms:.1f} ms wall (profiled); kernels busy {busy:.2f} ms of a "
          f"{span:.2f} ms device span (idle share {1 - busy / span:.3f})")
    for ms, name, count in rows[:6]:
        print(f"  {ms:9.3f} ms  x{count:<3d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_span_ms": span,
            "idle_share": 1 - busy / span,
            "top": [{"ms": ms, "name": name, "count": c} for ms, name, c in rows[:12]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=float, default=1.0, help="synthetic ogbn-products scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--details", help="write every measurement of the run to this JSON file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import stgraph_tpu_torch as port
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port from {ROOT}: {exc}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs stay f32 (the reference's arithmetic)
    rng = np.random.default_rng(args.seed)
    record = {"args": vars(args)}
    build_root = os.path.join(ROOT, "build")
    os.makedirs(build_root, exist_ok=True)
    t_start = time.perf_counter()
    try:
        record["environment"] = phase_environment(port)
        record["k1_checks"] = phase_k1_vs_plain(dev, rng)
        with tempfile.TemporaryDirectory(dir=build_root) as workdir:
            served = phase_serving(dev, args, workdir)
            record["serving"] = served["record"]
            per_launch, main_err = phase_k1_at_main_shapes(served)
            record["k1_main"] = per_launch
            try:
                record["profile"] = phase_profile(served)
            except Exception as exc:  # informational only: report and go on
                print(f"profile: unavailable ({type(exc).__name__}: {exc})")
            del served
            torch.cuda.empty_cache()
            record["model_check"] = phase_model_vs_plain(dev, args, workdir)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    launches = record["serving"]["launches"]
    check_err = max(record["k1_checks"]["max_abs_err"], main_err)
    kernels = [{
        "name": "spmm_rowmask (K1)",
        "route": "cuda",
        "source": "stgraph_tpu_torch/csrc/spmm_rowmask.cu",
        "replaces": "stgraph_tpu/ops/segment_pallas.py:761",
        "launches": launches,
        "max_abs_err": check_err,
        # one request's three launches (F = 128, 128, 47) at the main path's shapes
        "ms": sum(p["ms"] for p in per_launch),
        "plain_ms": sum(p["plain_ms"] for p in per_launch),
        "bound_ms": sum(p["bound_ms"] for p in per_launch),
        "bound_by": "bytes" if all(p["bound_by"] == "bytes" for p in per_launch) else "operations",
        "library_ms": (None if any(p["library_ms"] is None for p in per_launch)
                       else sum(p["library_ms"] for p in per_launch)),
        "per_launch": [{k: p[k] for k in ("F", "ms", "plain_ms", "bound_ms", "library_ms")} for p in per_launch],
    }]
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_start
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
        with open(args.details, "w") as fh:
            json.dump(record, fh, indent=1)
    print(f"total {record['total_s']:.1f} s")
    print(record["environment"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
