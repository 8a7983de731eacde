#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stgraph_tpu_torch``) on one NVIDIA GPU.

Phases (any failure exits nonzero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit, the
   nvcc version, and the time to build every kernel from the sources (one
   nvcc per source, all at once);
2. K1 against its plain version on the card, at F in {47, 100, 128},
   weighted and unweighted, f32 and bf16 streams, on a graph with empty rows
   and one hub row;
3. K2 against its plain version on the card, at F in {7, 16, 47, 100, 128,
   130}, f32 and bf16 streams, on the transpose of a graph with empty rows
   and a hub row in both directions;
4. serving, the first main path: a 3-layer GCN (100 -> 128 -> 128 -> 47,
   ReLU between layers, random weights from ``--seed`` carried through
   ``convert.py``) behind a ``Predictor`` on the synthetic ogbn-products
   graph (``--scale 1.0``: 2,449,029 nodes, 123,718,280 edges, so K1 and K2
   stream bf16) answers 3 requests. The launch counts are set to 0 just
   before and read just after; K1 must grow by 3 a request, K2 not at all.
   Each layer's output in the first request is held against the plain
   formula on 4096 sampled destination rows (and the largest hub);
5. K1 at the main path's shapes: the kernel, its plain version (in edge
   blocks, to bound memory) and ``torch.sparse.mm`` as a timed yardstick,
   with the full outputs compared;
6. a profile of one request (device time by kernel, idle share);
7. K2 at the main path's shapes (F = 128 and 47 on the transpose of the
   full graph): the kernel, its plain version and ``torch.sparse.mm`` plus
   ``torch.sparse.sampled_addmm`` as a timed yardstick, full outputs
   compared;
8. training, the second main path: the served GCN class with
   ``F.cross_entropy`` and ``torch.optim.AdamW(lr=1e-2, weight_decay=5e-4)``
   on the full graph, 1 warm step and 5 timed ones. The counts are set to 0
   just before the timed steps and read just after: 3 K1 and 3 K2 launches
   a step; the loss must be finite and fall;
9. a profile of one training step;
10. the unweighted route (``bench.py``'s formulation,
    ``spmm(csr, (h @ W) * norm) * norm``): one full-size step launches K1 6
    times (3 on the transpose) and K2 never;
11. checkpoint -> serve: the trained model and optimizer through
    ``Checkpointer``, ``Predictor.from_checkpoint`` answers one request,
    each layer held to its own forward on the same input;
12. the whole model at ``--scale 0.01`` against the plain torch path;
13. gradients at ``--scale 0.01`` against the plain torch path, for every
    parameter and for a ``GCNConv``'s edge weights;
14. Cora as ``benchmarking/gcn/train.py`` runs it (2 layers, hidden 16,
    AdamW, 200 epochs, the kernel route): train accuracy above 0.9;
15. TGCN on a 200k-edge weighted graph, 3 timesteps forward and backward,
    against the same run on the CPU's plain path;
16. K4, K8 (with and without its aux outputs) and K9 against their plain
    versions on the card, on K2's check graph, at (H, F) in {(8, 32),
    (1, 47), (8, 8), (4, 16)}, f32 and bf16 streams;
17. GAT serving, the third main path, on the graph the GCN phases built
    (their models and optimizer states released first): the GAT of
    ``benchmarking/gat/train.py`` at ``benchmarking/micro/ogbn_gat_bench.py``'s
    widths (GATConv(100, 32, 8 heads, ELU), heads concatenated to 256,
    GATConv(256, 47, 1 head), mean over the output heads; random weights
    from ``--seed`` through ``convert.py``) behind a ``Predictor`` answers
    3 requests, each launching K4 and K8 twice and K9 never;
18. K4, K8 and K9 at the main path's shapes (both layers' own scores and
    features, a random cotangent for K9): each kernel, its plain version (in
    edge blocks) and a library yardstick timed, full outputs compared;
19. GAT training, the fourth main path: ``F.cross_entropy`` and
    ``torch.optim.Adam(lr=5e-3)``, 1 warm step and 5 timed ones, each
    launching K4, K8 and K9 twice; the loss must be finite and fall;
20. a profile of one GAT training step;
21. the GAT model and its gradients at ``--scale 0.01`` against the plain
    torch path (the vertex program);
22. Pubmed as ``benchmarking/gat/train.py --dataset pubmed`` runs it (8 heads
    x 8 hidden, 1 output head, Adam 5e-3, 200 epochs, the flash route on an
    f32 stream): train accuracy at least ``PUBMED_ACC_FLOOR``.

Every path of the kernels line (serving, training, gat-serving,
gat-training) is driven with every launch count set to 0 just before it
and read just after.

The last two lines are the kernels JSON and ``{"ok": true, "device": ...}``.
``--details PATH`` also writes every measurement of the run as JSON.

    python3 chip_smoke.py [--scale 1.0] [--seed 0] [--details PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import re
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
# Gradients, kernel path vs the plain torch path, against the largest
# gradient of each tensor: the backward streams bf16 through three more
# SpMMs (K2 rounds g, fs, w and each product: four roundings of 2^-9) on
# top of the forward's, so six layers of up to four roundings, 24 * 2^-9.
GRAD_TOL = 5e-2
# CUDA vs CPU on the same plain-version arithmetic: the GEMMs and the
# f32 sums run in another order, so a value streamed as bf16 may round to
# the neighbouring bf16 number (2^-8 of it); 1e-2 of the largest value.
DEVICE_TOL = 1e-2

GCN_DIMS = (100, 128, 128, 47)
REQUESTS = 3
SAMPLE_ROWS = 4096
PLAIN_EDGE_BLOCK = 1 << 24  # bounds the plain version's temporaries (~25 GB)
K2_PLAIN_EDGE_BLOCK = 1 << 22  # K2's plain version also gathers fs: ~12 GB
TRAIN_STEPS = 5
CORA_DIMS, CORA_EPOCHS = (1433, 16, 7), 200
GAT_DIMS, GAT_HEADS = (100, 32, 47), (8, 1)  # in, hidden a head, classes; heads a layer
GAT_SLOPE = 0.2
GAT_CHECKS = ((8, 32), (1, 47), (8, 8), (4, 16))  # (H, F) held against the plain versions
GAT_PLAIN_EDGE_BLOCK = 1 << 21  # the plain K8/K9 gather (edges, H*F) planes: ~16 GB
PUBMED_DIMS, PUBMED_HEADS, PUBMED_EPOCHS = (500, 8, 3), (8, 1), 200
# ``benchmarking/gat/train.py --dataset pubmed --cpu`` (the JAX package on
# the CPU, synthetic Pubmed, 200 epochs) reaches train accuracy 0.6322; the
# port must reach it less 0.05 (PERF.md, section 4, Pubmed).
PUBMED_ACC_FLOOR = 0.6322 - 0.05


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _counters():
    from stgraph_tpu_torch.ops import flash_gat, segment_kernels, spmm_kernels

    return {"K1": spmm_kernels.spmm_rowmask, "K2": spmm_kernels.spmm_rowmask_bwd,
            "K4": segment_kernels.segment_max_narrow, "K8": flash_gat.flash_gat_fwd,
            "K9": flash_gat.flash_gat_bwd}


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    for fn in _counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in _counters().items()}


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


def k2_bound(n: int, e: int, f: int):
    """Least time for one K2 call: indptr, cols, w and dw once each, the f32
    g and fs tables read once, the f32 dh written once, over HBM; or 4 f32
    operations per edge and column over the f32 peak."""
    nbytes = (n + 1) * 4 + 3 * e * 4 + 3 * n * f * 4
    ops = 4 * e * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _err_over_mass(err, mass):
    return (err / mass.clamp(min=1e-30)).masked_fill(err == 0, 0.0).max().item()


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
    ratio = _err_over_mass(err, mass)
    return max_err, ratio, max_ref


def k2_agreement(dh, dw, csr_t, w, g, fs, stream, edge_block=None):
    """Hold K2's ``dh`` and ``dw`` against its plain version on the same
    inputs. Returns per output (max_abs_err, worst err / sum|terms|, max
    |plain|), and whether every padding slot of ``dw`` is exactly 0."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd_plain

    refs = spmm_rowmask_bwd_plain(csr_t, w, g, fs, stream, edge_block)
    errs = [(out - ref).abs() for out, ref in zip((dh, dw), refs)]
    max_refs = [ref.abs().max().item() for ref in refs]
    del refs
    masses = spmm_rowmask_bwd_plain(csr_t, w.abs(), g.abs(), fs.abs(), stream, edge_block)
    stats = [(err.max().item(), _err_over_mass(err, mass), m)
             for err, mass, m in zip(errs, masses, max_refs)]
    return stats[0], stats[1], not dw[csr_t.num_edges:].any().item()


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
    ptxas = {}
    for name, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
        ptxas[name] = {"kernels": len(regs), "max_registers": max(regs, default=0),
                       "spilling": sum(b > 0 for b in spills), "max_spill_stores": max(spills, default=0)}
        print(f"  ptxas[{name}]: {len(regs)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"{ptxas[name]['spilling']} with spill stores (at most {ptxas[name]['max_spill_stores']} B)")
    return {"nvidia_smi": smi, "nvcc": nvcc, "build_s": build_s, "ptxas": ptxas}


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


def phase_k2_vs_plain(dev, rng):
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd

    n, e, empty, hub, hub_deg = 200_000, 4_000_000, 1000, 12_345, 300_000
    src = rng.integers(0, n - empty, e)  # the transpose's rows: 1000 empty
    dst = rng.integers(0, n - empty, e)
    dst[:hub_deg] = hub
    src[-hub_deg:] = hub + 1  # a hub row of the transpose too
    csr_t = build_csr(src, dst, n, device=dev).transpose()
    results, worst = [], 0.0
    for f in (7, 16, 47, 100, 128, 130):
        g = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
        fs = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.standard_normal(csr_t.capacity).astype(np.float32)).to(dev)
        for stream in (torch.float32, torch.bfloat16):
            dh, dw = spmm_rowmask_bwd(csr_t, w, g, fs, stream_dtype=stream)
            torch.cuda.synchronize()
            (dh_err, dh_ratio, dh_ref), (dw_err, dw_ratio, dw_ref), pad_zero = k2_agreement(
                dh, dw, csr_t, w, g, fs, stream)
            ok = (dh_ratio <= KERNEL_TOL and dw_ratio <= KERNEL_TOL and pad_zero
                  and not dh[n - empty:].any().item())
            tag = f"F={f} {str(stream)[6:]} stream"
            print(f"k2-check {tag}: dh max_abs_err {dh_err:.3e} (max |plain| {dh_ref:.1f}, "
                  f"err/sum|terms| {dh_ratio:.2e}); dw max_abs_err {dw_err:.3e} (max |plain| "
                  f"{dw_ref:.1f}, err/sum|terms| {dw_ratio:.2e}); padding dw zero {pad_zero} "
                  f"(tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K2 disagrees with its plain version at {tag}")
            worst = max(worst, dh_err, dw_err)
            results.append({"case": tag, "dh_max_abs_err": dh_err, "dh_err_over_mass": dh_ratio,
                            "dw_max_abs_err": dw_err, "dw_err_over_mass": dw_ratio})
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


def build_model(graph, impl, dev, seed, dims=GCN_DIMS):
    from stgraph_tpu_torch.convert import gcn_params_from_jax

    model = GCN(graph, dims, impl, dev)
    model.load_state_dict(gcn_params_from_jax(numpy_gcn_params(dims, seed)))
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
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd
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
    reset_counts()
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
    counts = read_counts()
    launches = counts["K1"]
    check(counts == {"K1": 3 * REQUESTS, "K2": 0, "K4": 0, "K8": 0, "K9": 0},
          f"serving launched {counts}, expected K1 only")
    print(f"serve: {REQUESTS} requests, K1 launches {launches}, K2 launches 0, per-request s "
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
        "labels": torch.from_numpy(data.get_all_targets()).to(dev),
        "inputs": [h for h, _ in captured], "launches": launches, "counts": counts,
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


def phase_profile(fn, what):
    """Device time by kernel over one call of ``fn``, and the device's idle
    share between its first and last kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # the profiler's own first-use cost stays out of the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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
    print(f"profile: {what} {wall_ms:.1f} ms wall (profiled); kernels busy {busy:.2f} ms of a "
          f"{span:.2f} ms device span (idle share {1 - busy / span:.3f})")
    for ms, name, count in rows[:8]:
        print(f"  {ms:9.3f} ms  x{count:<3d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_span_ms": span,
            "idle_share": 1 - busy / span,
            "top": [{"ms": ms, "name": name, "count": c} for ms, name, c in rows[:12]]}


def phase_k2_at_main_shapes(served):
    """K2 on the transpose of the full graph at the widths a training step
    gives it (F = 128 and 47), with the forward's own weights and features
    (``fs``) and a random cotangent."""
    from stgraph_tpu_torch.ops import message as M
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd, spmm_rowmask_bwd_plain
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    graph = served["graph"]
    csr = graph.fwd_csr
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    t0 = time.perf_counter()
    csr_t = csr.transpose()
    t1 = time.perf_counter()
    perm_t, _, _ = csr.edge_perms()
    t2 = time.perf_counter()
    max_out = int(np.diff(csr_t.host_arrays()[0]).max())
    print(f"k2-main setup: transpose CSR (host counting sort + upload) {t1 - t0:.2f} s, "
          f"edge permutations {t2 - t1:.2f} s, largest out-degree {max_out}")
    per_launch, worst = [], 0.0
    gen = torch.Generator(device=csr.device).manual_seed(7)
    bf16 = torch.bfloat16
    with torch.inference_mode():
        w = M.gather_src(csr, symmetric_norm(graph)).reshape(-1)
        w_t = w.index_select(0, perm_t)
        pattern = torch.sparse_csr_tensor(csr_t.indptr, csr_t.cols[:e], w_t[:e], size=(n, n),
                                          check_invariants=False)
        for layer, h_in in (pair for i, pair in enumerate(zip(served["model"].layers, served["inputs"]))
                            if i in (1, 2)):
            fs = h_in @ layer.weight
            f = fs.shape[1]
            g = torch.randn(fs.shape, device=fs.device, generator=gen)
            dh, dw = spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=bf16)
            torch.cuda.synchronize()
            (dh_err, dh_ratio, _), (dw_err, dw_ratio, _), pad_zero = k2_agreement(
                dh, dw, csr_t, w_t, g, fs, bf16, K2_PLAIN_EDGE_BLOCK)
            check(dh_ratio <= KERNEL_TOL and dw_ratio <= KERNEL_TOL and pad_zero,
                  f"K2 at F={f} (full graph) disagrees: dh {dh_ratio}, dw {dw_ratio}, padding zero {pad_zero}")
            del dh, dw
            ms = cuda_ms(lambda: spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=bf16), iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: spmm_rowmask_bwd_plain(csr_t, w_t, g, fs, bf16, K2_PLAIN_EDGE_BLOCK),
                               iters=2, warmup=1)
            lib = {}
            for name, fn in (("sparse.mm", lambda: torch.sparse.mm(pattern, g)),
                             ("sampled_addmm", lambda: torch.sparse.sampled_addmm(pattern, fs, g.t(), beta=0.0))):
                try:  # a timed yardstick only; the port never calls it
                    lib[name] = cuda_ms(fn, iters=3, warmup=1)
                except RuntimeError as exc:
                    print(f"library yardstick {name} unavailable at F={f}: {exc}")
                    lib[name] = None
            lib_ms = None if None in lib.values() else sum(lib.values())
            bound_ms, bound_by, nbytes, ops = k2_bound(n, e, f)
            print(f"k2-main F={f}: {ms:.3f} ms (plain {plain_ms:.1f} ms, torch.sparse.mm "
                  f"{lib['sparse.mm']} ms + sampled_addmm {lib['sampled_addmm']} ms, bound {bound_ms:.3f} ms "
                  f"by {bound_by}); full-graph dh max_abs_err {dh_err:.3e} (err/sum|terms| "
                  f"{dh_ratio:.2e}), dw max_abs_err {dw_err:.3e} (err/sum|terms| {dw_ratio:.2e})")
            worst = max(worst, dh_err, dw_err)
            per_launch.append({"F": f, "E": e, "N": n, "stream": "bf16", "ms": ms, "plain_ms": plain_ms,
                               "library_ms": lib_ms, "library_parts_ms": lib, "bound_ms": bound_ms,
                               "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                               "dh_max_abs_err": dh_err, "dh_err_over_mass": dh_ratio,
                               "dw_max_abs_err": dw_err, "dw_err_over_mass": dw_ratio})
    return per_launch, worst, {"transpose_s": t1 - t0, "edge_perms_s": t2 - t1, "max_out_degree": max_out}


def phase_training(dev, args, served):
    """The served GCN class trained on the full graph: the main path of the
    training slice."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd

    graph, feats, labels = served["graph"], served["feats"], served["labels"]
    model = build_model(graph, "auto", dev, args.seed).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=5e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(feats), labels)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.item()

    t = time.perf_counter()
    warm_loss = step()
    warm_s = time.perf_counter() - t
    losses, times, per_step = [], [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        before = spmm_rowmask.launches, spmm_rowmask_bwd.launches
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
        per_step.append((spmm_rowmask.launches - before[0], spmm_rowmask_bwd.launches - before[1]))
    launches = read_counts()
    check(launches["K4"] == launches["K8"] == launches["K9"] == 0, f"GCN training launched {launches}")
    print(f"train: warm step {warm_s:.3f} s (loss {warm_loss:.4f}); {TRAIN_STEPS} AdamW steps, "
          f"s per step {[round(t, 4) for t in times]}, losses {[round(v, 4) for v in losses]}, "
          f"launches per step (K1, K2) {per_step}")
    check(all(c == (3, 3) for c in per_step), f"a training step launched (K1, K2) {per_step}, expected (3, 3)")
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "non-finite training loss")
    check(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    return {"model": model, "optimizer": opt, "step": step, "launches": launches,
            "record": {"warm_s": warm_s, "warm_loss": warm_loss, "step_s": times, "losses": losses,
                       "launches_per_step": per_step, "launches": launches}}


def phase_unweighted_step(dev, args, served):
    """``bench.py``'s training step formulation: the norms outside the SpMM,
    so it runs unweighted and its backward is K1 on the transpose."""
    from stgraph_tpu_torch.ops import message as M
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    graph, feats, labels = served["graph"], served["feats"], served["labels"]
    csr = graph.fwd_csr
    norm = symmetric_norm(graph)
    rng = np.random.default_rng(args.seed)
    ws = [torch.from_numpy((rng.standard_normal((a, b)) * 0.05).astype(np.float32)).to(dev).requires_grad_()
          for a, b in zip(GCN_DIMS[:-1], GCN_DIMS[1:])]

    def step():
        h = feats
        for i, w in enumerate(ws):
            h = M.spmm(csr, (h @ w) * norm, impl="kernel") * norm
            if i < len(ws) - 1:
                h = torch.relu(h)
        loss = torch.nn.functional.cross_entropy(h, labels)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item()

    step()  # warm
    spmm_rowmask.launches = spmm_rowmask_bwd.launches = 0
    t = time.perf_counter()
    loss = step()
    step_s = time.perf_counter() - t
    counts = (spmm_rowmask.launches, spmm_rowmask_bwd.launches)
    print(f"unweighted step: {step_s:.4f} s, loss {loss:.4f}, launches (K1, K2) {counts}")
    check(counts == (6, 0), f"the unweighted step launched (K1, K2) {counts}, expected (6, 0)")
    check(np.isfinite(loss) and all(bool(torch.isfinite(w.grad).all()) for w in ws), "non-finite step")
    return {"step_s": step_s, "loss": loss, "launches": {"K1": counts[0], "K2": counts[1]}}


def phase_checkpoint_serve(dev, served, trained, workdir):
    """Save the trained model and optimizer, serve from the checkpoint, and
    hold each served layer to the trained layer's own forward on the same
    input (they differ only by the order of K1's split-row atomics)."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_plain
    from stgraph_tpu_torch.serve import Predictor
    from stgraph_tpu_torch.utils import Checkpointer
    from stgraph_tpu_torch.utils.norm import symmetric_norm
    from stgraph_tpu_torch.ops import message as M

    graph, feats = served["graph"], served["feats"]
    model, opt = trained["model"], trained["optimizer"]
    ckdir = os.path.join(workdir, "checkpoints")
    t = time.perf_counter()
    Checkpointer(ckdir).save(1 + TRAIN_STEPS, {"model": model.state_dict(), "optimizer": opt.state_dict()})
    save_s = time.perf_counter() - t
    like = {"model": model.state_dict(), "optimizer": opt.state_dict()}

    def apply_fn(state, x):
        return torch.func.functional_call(model, state["model"], (x,))

    t = time.perf_counter()
    predictor = Predictor.from_checkpoint(ckdir, apply_fn, like, (feats,), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    captured = []
    hooks = [layer.register_forward_hook(lambda mod, inp, out: captured.append((inp[1], out)))
             for layer in model.layers]
    logits = predictor(feats)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    check(tuple(logits.shape) == (graph.get_num_nodes(), GCN_DIMS[-1]) and bool(torch.isfinite(logits).all()),
          "the checkpointed model served bad logits")
    csr = graph.fwd_csr
    worst, checks = 0.0, []
    with torch.inference_mode():
        w_abs = M.gather_src(csr, symmetric_norm(graph)).abs()
        bit_equal = torch.equal(logits, model(feats))
        for i, (layer, (x_in, y_served)) in enumerate(zip(model.layers, captured)):
            y = layer(graph, x_in)
            err = (y_served - y).abs()
            hw = x_in @ layer.weight
            mass = spmm_rowmask_plain(csr, w_abs, hw.abs(), torch.bfloat16, PLAIN_EDGE_BLOCK)
            mass = mass * symmetric_norm(graph)
            bound = KERNEL_TOL * mass + 1e-6 * y.abs()  # + one rounding of the bias add
            ok = bool((err <= bound).all())
            ratio = _err_over_mass(err, mass)
            print(f"checkpoint-serve layer {i}: max_abs_err {err.max().item():.3e} vs its own forward, "
                  f"worst err/(norm*sum|terms|) {ratio:.2e} {'ok' if ok else 'FAIL'}")
            check(ok, f"served layer {i} from the checkpoint disagrees with the trained layer")
            worst = max(worst, err.max().item())
            checks.append({"layer": i, "max_abs_err": err.max().item(), "err_over_mass": ratio})
    print(f"checkpoint-serve: save {save_s:.3f} s, from_checkpoint (restore + warm call) {restore_s:.3f} s, "
          f"logits bit-equal to the trained model's forward: {bit_equal}")
    return {"save_s": save_s, "restore_s": restore_s, "bit_equal": bit_equal, "layers": checks,
            "max_abs_err": worst}


def phase_grads_vs_plain(dev, args, workdir):
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.nn import GCNConv

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    x = torch.from_numpy(data.get_all_features()).to(dev)
    y = torch.from_numpy(data.get_all_targets()).to(dev)
    grads = {}
    for impl in ("auto", "torch"):
        model = build_model(graph, impl, dev, args.seed)
        torch.nn.functional.cross_entropy(model(x), y).backward()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
    e = graph.get_num_edges()
    rng = np.random.default_rng(args.seed + 2)
    ew = torch.from_numpy(rng.random(e).astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((n, 47)).astype(np.float32)).to(dev)
    for impl in ("auto", "torch"):
        conv = GCNConv(100, 47, impl=impl, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
        w = ew.clone().requires_grad_()
        (conv(graph, x, w) * r).sum().backward()
        grads[impl]["edge_weight"] = w.grad
        grads[impl]["conv.weight (weighted)"] = conv.weight.grad
    worst, rows = 0.0, []
    for k, ref in grads["torch"].items():
        err = (grads["auto"][k] - ref).abs().max().item()
        ratio = err / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        rows.append({"tensor": k, "max_abs_err": err, "err_over_max": ratio})
        print(f"grad-check {k}: kernel path vs plain torch path max_abs_err {err:.3e}, "
              f"{ratio:.2e} of the largest (tol {GRAD_TOL:g}) {'ok' if ratio <= GRAD_TOL else 'FAIL'}")
    check(worst <= GRAD_TOL, "a gradient on the kernel path disagrees with the plain path at scale 0.01")
    return {"n": n, "e": e, "grads": rows, "worst_err_over_max": worst}


def phase_cora(dev, args, workdir):
    """``benchmarking/gcn/train.py`` on the port: 2 GCN layers, hidden 16,
    AdamW(1e-2, 5e-4), 200 full-graph epochs, the kernel route."""
    from stgraph_tpu_torch.dataset import CoraDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd
    from stgraph_tpu_torch.utils import accuracy

    STGraphDataset._offline = True  # no network here: the synthetic Cora, without a download attempt
    cora = CoraDataLoader(cache_dir=os.path.join(workdir, "datasets"))
    n = cora.gdata["num_nodes"]
    graph = StaticGraph(cora.get_edges(), None, n, device=dev)
    x = torch.from_numpy(cora.get_all_features()).to(dev)
    y = torch.from_numpy(cora.get_all_targets()).to(dev)
    model = build_model(graph, "kernel", dev, args.seed, dims=CORA_DIMS).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=5e-4)
    spmm_rowmask.launches = spmm_rowmask_bwd.launches = 0
    times = []
    for epoch in range(CORA_EPOCHS):
        t = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        if epoch >= 3:
            times.append(time.perf_counter() - t)
    counts = (spmm_rowmask.launches, spmm_rowmask_bwd.launches)
    with torch.inference_mode():
        acc = accuracy(model(x), y)
    epoch_s = float(np.mean(times))
    print(f"cora: synthetic={cora.synthetic} N={n} E={cora.gdata['num_edges']}, {CORA_EPOCHS} epochs, "
          f"mean epoch (>=3) {epoch_s * 1e3:.3f} ms, final loss {loss.item():.4f}, train acc {acc:.4f}, "
          f"launches (K1, K2) {counts}")
    check(counts == (2 * CORA_EPOCHS, 2 * CORA_EPOCHS), f"Cora launched (K1, K2) {counts}")
    check(acc > 0.9, f"Cora train accuracy {acc:.4f} is not above 0.9")
    return {"synthetic": cora.synthetic, "epoch_s": epoch_s, "train_acc": acc, "loss": loss.item(),
            "launches": {"K1": counts[0], "K2": counts[1]}}


def phase_tgcn(dev, rng):
    """TGCN, 3 timesteps forward and backward on a 200k-edge weighted graph
    (K1 and K2 stream bf16), against the same run on the CPU's plain path."""
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.nn import TGCN
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd

    n, e, cin, cout, steps = 10_000, 200_000, 16, 32, 3
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    ew = rng.random(e).astype(np.float32)
    xs = [rng.standard_normal((n, cin)).astype(np.float32) for _ in range(steps)]
    target = rng.standard_normal((n, cout)).astype(np.float32)
    ref_layer = TGCN(cin, cout, impl="kernel", device="cpu", generator=torch.Generator().manual_seed(5))
    results = []  # the CPU's plain path, then the card's kernel path
    for d in (torch.device("cpu"), dev):
        layer = TGCN(cin, cout, impl="kernel", device=d)
        layer.load_state_dict(ref_layer.state_dict())
        graph = StaticGraph(edges, None, n, device=d)
        w = torch.from_numpy(ew).to(d)
        x = [torch.from_numpy(v).to(d).requires_grad_() for v in xs]
        before = spmm_rowmask.launches, spmm_rowmask_bwd.launches
        h = None
        for xt in x:
            h = layer(graph, xt, w, h)
        ((h - torch.from_numpy(target).to(d)) ** 2).mean().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = (spmm_rowmask.launches - before[0], spmm_rowmask_bwd.launches - before[1])
            check(counts == (3 * steps, 3 * steps), f"TGCN launched (K1, K2) {counts}, expected 9 each")
        tensors = {"h": h.detach()}
        tensors.update({f"grad {k}": p.grad for k, p in layer.named_parameters()})
        tensors.update({f"grad x{i}": v.grad for i, v in enumerate(x)})
        results.append({k: v.cpu() for k, v in tensors.items()})
    worst = 0.0
    for k, ref in results[0].items():
        ratio = (results[1][k] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
    print(f"tgcn: N={n} E={e} {cin}->{cout}, {steps} timesteps fwd+bwd, CUDA kernel path vs CPU plain "
          f"path: worst max_abs_err / max |ref| over h and {len(results[0]) - 1} gradients "
          f"{worst:.2e} (tol {DEVICE_TOL:g}) {'ok' if worst <= DEVICE_TOL else 'FAIL'}")
    check(worst <= DEVICE_TOL, "TGCN on the card disagrees with the CPU's plain path")
    return {"n": n, "e": e, "worst_err_over_max": worst}


def k4_bound(n: int, e: int, h: int):
    """Least time for one K4 call (index form): indptr, cols and the (N, H)
    f32 table read once, the (N, H) output written once; or one compare per
    edge and head over the f32 peak."""
    nbytes = (n + 1) * 4 + e * 4 + 2 * n * h * 4
    ops = e * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k8_bound(n: int, e: int, h: int, f: int, aux: bool):
    """Least time for one K8 call: indptr, cols, el, er, m and the f32 fs
    table read once, out and den (and u, p) written once; or, per edge, ~7
    operations a head (9 with aux: add, leaky, subtract, min, exp, sums)
    and 2 a column (4 with aux) over the f32 peak."""
    hf = h * f
    nbytes = (n + 1) * 4 + e * 4 + 3 * n * h * 4 + n * hf * 4 + (n * hf + n * h) * 4 * (2 if aux else 1)
    ops = e * h * (9 if aux else 7) + e * hf * (4 if aux else 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k9_bound(n: int, e: int, h: int, f: int):
    """Least time for one K9 call: the transpose's indptr and cols, el, er,
    m, c and the f32 gu and fs tables read once, dfs and dl written once;
    or ~10 operations per edge and head and 4 per edge and column."""
    hf = h * f
    nbytes = (n + 1) * 4 + e * 4 + 4 * n * h * 4 + 3 * n * hf * 4 + n * h * 4
    ops = e * h * 10 + e * hf * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _stats(outs, refs, masses):
    """Per output: (max_abs_err, worst err / sum|terms|, max |plain|)."""
    rows = []
    for out, ref, mass in zip(outs, refs, masses):
        err = (out - ref).abs()
        rows.append((err.max().item(), _err_over_mass(err, mass), ref.abs().max().item()))
    return rows


def k8_agreement(outs, csr, el, er, m, fs, h, stream, edge_block=None):
    """Hold K8's (out, den[, u, p]) against its plain version. The sums of
    absolute terms come from the plain version on |fs| (the weights are
    positive): sum w|fs| / den for out, sum w lp |fs| for u, and den and p
    themselves."""
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_fwd_plain

    aux = outs[2] is not None
    refs = flash_gat_fwd_plain(csr, el, er, m, fs, h, GAT_SLOPE, stream, aux, edge_block)
    masses = flash_gat_fwd_plain(csr, el, er, m, fs.abs(), h, GAT_SLOPE, stream, aux, edge_block)
    keep = [i for i, r in enumerate(refs) if r is not None]
    return _stats([outs[i] for i in keep], [refs[i] for i in keep], [masses[i] for i in keep])


def k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, stream, edge_block=None):
    """Hold K9's (dfs, dl) against its plain version. Sums of absolute
    terms: sum w |gu| for dfs; sum w lp (sum_f |fs gu| + |c|) for dl, the
    plain version on |fs|, |gu| and -|c|."""
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_bwd_plain

    refs = flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, stream, edge_block)
    masses = flash_gat_bwd_plain(csr_t, el, er, m, -c.abs(), gu.abs(), fs.abs(), h, GAT_SLOPE, stream,
                                 edge_block)
    return _stats((dfs, dl), refs, masses)


def _node_cotangents(g, out, den, h):
    """K9's node-level inputs from a cotangent g of the normalised output:
    gu = g / den and c = sum_f g * out / den, as the backward forms them."""
    n, hf = g.shape
    denom = den.clamp(min=torch.finfo(torch.float32).tiny)
    gu = (g.reshape(n, h, -1) / denom[:, :, None]).reshape(n, hf)
    c = (g * out).reshape(n, h, -1).sum(-1) / denom
    return gu, c


def phase_gat_kernels_vs_plain(dev, rng, n=200_000, e=4_000_000, hub_deg=300_000):
    """K4, K8 (with and without aux) and K9 against their plain versions on
    K2's check graph: 1000 empty rows, a 300k-edge hub in each direction."""
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd, stability_max
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow, segment_max_narrow_plain

    empty, hub = 1000, 12_345
    src = rng.integers(0, n - empty, e)
    dst = rng.integers(0, n - empty, e)
    dst[:hub_deg] = hub
    src[-hub_deg:] = hub + 1
    csr = build_csr(src, dst, n, device=dev)
    csr_t = csr.transpose()
    results, worst = [], {"K4": 0.0, "K8": 0.0, "K9": 0.0}

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    for h, f in GAT_CHECKS:
        el, er = randn(n, h), randn(n, h)
        fs, g = randn(n, h * f), randn(n, h * f)
        elmax = segment_max_narrow(csr, el, index=csr.cols)
        torch.cuda.synchronize()
        k4_err = (elmax - segment_max_narrow_plain(csr, el, index=csr.cols)).abs().max().item()
        check(k4_err == 0.0, f"K4 disagrees with its plain version at H={h}: {k4_err}")
        m = stability_max(csr, el, er, GAT_SLOPE)
        for stream in (torch.float32, torch.bfloat16):
            tag = f"H={h} F={f} {str(stream)[6:]} stream"
            fwd = {}
            for aux in (False, True):
                outs = flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, stream, aux=aux)
                torch.cuda.synchronize()
                fwd[aux] = outs
                stats = k8_agreement(outs, csr, el, er, m, fs, h, stream, GAT_PLAIN_EDGE_BLOCK)
                ok = (all(r <= KERNEL_TOL for _, r, _ in stats)
                      and not outs[0][n - empty:].any().item() and not outs[1][n - empty:].any().item())
                names = ("out", "den", "u", "p")
                print(f"k8-check {tag} aux={aux}: " + "; ".join(
                    f"{nm} max_abs_err {a:.3e} (err/sum|terms| {r:.2e})" for nm, (a, r, _) in zip(names, stats))
                    + f" (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"K8 disagrees with its plain version at {tag}, aux={aux}")
                worst["K8"] = max(worst["K8"], *(a for a, _, _ in stats))
                results.append({"kernel": "K8", "case": tag, "aux": aux,
                                "stats": [{"output": nm, "max_abs_err": a, "err_over_mass": r, "max_abs_plain": mx}
                                          for nm, (a, r, mx) in zip(names, stats)]})
            gu, c = _node_cotangents(g, fwd[True][0], fwd[True][1], h)
            dfs, dl = flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, stream)
            torch.cuda.synchronize()
            (dfs_a, dfs_r, _), (dl_a, dl_r, _) = k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, stream,
                                                               GAT_PLAIN_EDGE_BLOCK)
            ok = (dfs_r <= KERNEL_TOL and dl_r <= KERNEL_TOL
                  and not dfs[n - empty:].any().item() and not dl[n - empty:].any().item())
            print(f"k9-check {tag}: dfs max_abs_err {dfs_a:.3e} (err/sum|terms| {dfs_r:.2e}); dl max_abs_err "
                  f"{dl_a:.3e} (err/sum|terms| {dl_r:.2e}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K9 disagrees with its plain version at {tag}")
            worst["K9"] = max(worst["K9"], dfs_a, dl_a)
            results.append({"kernel": "K9", "case": tag, "dfs_max_abs_err": dfs_a, "dfs_err_over_mass": dfs_r,
                            "dl_max_abs_err": dl_a, "dl_err_over_mass": dl_r})
        print(f"k4-check H={h}: bit-equal to its plain version (max_abs_err {k4_err})")
        results.append({"kernel": "K4", "case": f"H={h}", "max_abs_err": k4_err})
    return {"graph": {"n": n, "e": e, "empty_rows": empty, "hub_deg": hub_deg},
            "cases": results, "max_abs_err": worst}


class GAT(torch.nn.Module):
    """``benchmarking/gat/train.py``'s model: GATConv with ELU, the heads
    concatenated, GATConv, the mean over the output heads."""

    def __init__(self, graph, dims, heads, impl, device, generator=None):
        super().__init__()
        from stgraph_tpu_torch.nn import GATConv

        fin, hidden, classes = dims
        self.graph = graph
        self.layers = torch.nn.ModuleList([
            GATConv(fin, hidden, heads[0], negative_slope=GAT_SLOPE, activation=torch.nn.functional.elu,
                    impl=impl, device=device, generator=generator),
            GATConv(hidden * heads[0], classes, heads[1], negative_slope=GAT_SLOPE, impl=impl, device=device,
                    generator=generator),
        ])

    def forward(self, h):
        h = self.layers[0](self.graph, h).reshape(h.shape[0], -1)
        return self.layers[1](self.graph, h).mean(1)


def numpy_gat_params(dims, heads, seed):
    """A flax-shaped GAT parameter tree made with numpy from ``seed``: the
    JAX layer's initialiser, variance_scaling(2.0, fan_avg, normal), on
    ``fc.kernel`` (in, H*F) and on the (H, F) attention vectors."""
    rng = np.random.default_rng(seed)
    fin, hidden, classes = dims
    tree = {}
    for i, (a, f, h) in enumerate(((fin, hidden, heads[0]), (hidden * heads[0], classes, heads[1]))):
        def normal(shape):
            return (rng.standard_normal(shape) * np.sqrt(4.0 / sum(shape))).astype(np.float32)

        tree[f"GATConv_{i}"] = {"fc": {"kernel": normal((a, h * f))}, "attn_l": normal((h, f)),
                                "attn_r": normal((h, f))}
    return {"params": tree}


def build_gat(graph, impl, dev, seed, dims=GAT_DIMS, heads=GAT_HEADS):
    from stgraph_tpu_torch.convert import gat_params_from_jax

    model = GAT(graph, dims, heads, impl, dev)
    model.load_state_dict(gat_params_from_jax(numpy_gat_params(dims, heads, seed)))
    return model.eval()


def phase_gat_serving(dev, args, base):
    """The GAT behind a ``Predictor`` on the full graph: 3 requests, each
    launching K4 and K8 twice (no aux outputs) and nothing else."""
    from stgraph_tpu_torch.serve import Predictor

    graph, feats = base["graph"], base["feats"]
    n = graph.get_num_nodes()
    t = time.perf_counter()
    model = build_gat(graph, "auto", dev, args.seed)
    predictor = Predictor.build(model, dict(model.state_dict()), (feats,), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    captured = []
    hooks = [layer.register_forward_hook(lambda mod, inp, out: captured.append(inp[1]))
             for layer in model.layers]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    requests = [feats] + [
        feats + 0.1 * torch.randn(feats.shape, device=dev, generator=gen) for _ in range(REQUESTS - 1)
    ]
    torch.cuda.synchronize()
    times, per_request = [], []
    reset_counts()
    for r, x in enumerate(requests):
        before = read_counts()
        t = time.perf_counter()
        logits = predictor(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if r == 0:
            for hk in hooks:
                hk.remove()
        delta = {k: v - before[k] for k, v in read_counts().items()}
        per_request.append(delta)
        check(delta == {"K1": 0, "K2": 0, "K4": 2, "K8": 2, "K9": 0},
              f"GAT request {r} launched {delta}, expected K4 and K8 twice each")
        check(tuple(logits.shape) == (n, GAT_DIMS[-1]), f"GAT logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all().item()), f"GAT request {r}: non-finite logits")
    counts = read_counts()
    print(f"gat-serve: model+Predictor.build (warm call) {build_s:.2f} s; {REQUESTS} requests, launches "
          f"{counts}, per-request s {[round(v, 4) for v in times]}, logits finite, shape {tuple(logits.shape)}")
    return {"model": model, "predictor": predictor, "inputs": captured, "counts": counts,
            "record": {"build_s": build_s, "request_s": times, "launches": counts,
                       "launches_per_request": per_request}}


def _library_k4_ms(csr, el, e):
    """``torch.segment_reduce(max)`` over the gathered (E, H) plane (the
    gather itself not timed): a timed yardstick only."""
    try:
        plane = el.index_select(0, csr.cols[:e].long())
        offsets = csr.indptr.long()
        ms = cuda_ms(lambda: torch.segment_reduce(plane, "max", offsets=offsets, unsafe=True), iters=5)
        del plane
        return ms
    except (RuntimeError, TypeError) as exc:
        print(f"library yardstick segment_reduce unavailable: {exc}")
        return None


def _library_k8_ms(csr, el, er, fs, h, e):
    """Per head, ``torch.sparse.softmax`` of the scores over the CSR's
    pattern and ``torch.sparse.mm`` of the result with that head's features:
    two timed calls a head, summed; a timed yardstick only."""
    try:
        rows, cols = csr.rows[:e].long(), csr.cols[:e].long()
        idx = torch.stack([rows, cols])
        n = csr.num_nodes
        f = fs.shape[1] // h
        total = 0.0
        for k in range(h):
            s = el[cols, k] + er[rows, k]
            s = torch.where(s >= 0, s, GAT_SLOPE * s)
            # the CSR's edge order is row-major sorted, as a coalesced COO's
            a = torch.sparse_coo_tensor(idx, s, (n, n), is_coalesced=True)
            alpha = torch.sparse.softmax(a, dim=1)
            x = fs[:, k * f:(k + 1) * f].contiguous()
            total += cuda_ms(lambda: torch.sparse.softmax(a, dim=1), iters=3)
            total += cuda_ms(lambda: torch.sparse.mm(alpha, x), iters=3)
            del a, alpha, x, s
        return total
    except (RuntimeError, TypeError) as exc:
        print(f"library yardstick sparse.softmax + sparse.mm unavailable: {exc}")
        return None


def phase_gat_kernels_at_main_shapes(dev, gat):
    """K4, K8 and K9 on the full graph with each GAT layer's own scores and
    features (captured from the first request) and a random cotangent."""
    from stgraph_tpu_torch.ops.flash_gat import (flash_gat_bwd, flash_gat_bwd_plain, flash_gat_fwd,
                                                 flash_gat_fwd_plain, stability_max)
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow, segment_max_narrow_plain

    graph = gat["model"].graph
    csr = graph.fwd_csr
    csr_t = csr.transpose()
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"K4": [], "K8": [], "K8_serving": [], "K9": []}
    worst = {"K4": 0.0, "K8": 0.0, "K9": 0.0}
    with torch.inference_mode():
        for layer, h_in in zip(gat["model"].layers, gat["inputs"]):
            h, f = layer.num_heads, layer.out_feats
            feat_src = layer.fc(h_in).reshape(n, h, f)
            el = (feat_src * layer.attn_l).sum(-1)
            er = (feat_src * layer.attn_r).sum(-1)
            fs = feat_src.reshape(n, h * f)
            del feat_src
            # K4: exact, so its plain version must agree bit for bit
            elmax = segment_max_narrow(csr, el, index=csr.cols)
            torch.cuda.synchronize()
            k4_err = (elmax - segment_max_narrow_plain(csr, el, index=csr.cols, edge_block=1 << 24)).abs().max().item()
            check(k4_err == 0.0, f"K4 at H={h} (full graph) disagrees: {k4_err}")
            k4_ms = cuda_ms(lambda: segment_max_narrow(csr, el, index=csr.cols), iters=10, warmup=2)
            k4_plain = cuda_ms(lambda: segment_max_narrow_plain(csr, el, index=csr.cols, edge_block=1 << 24),
                               iters=1, warmup=1)
            k4_lib = _library_k4_ms(csr, el, e)
            bound = k4_bound(n, e, h)
            print(f"k4-main H={h}: {k4_ms:.3f} ms (plain {k4_plain:.1f} ms, segment_reduce {k4_lib} ms, "
                  f"bound {bound[0]:.3f} ms by {bound[1]}); bit-equal to its plain version")
            out["K4"].append({"H": h, "F": h, "E": e, "N": n, "ms": k4_ms, "plain_ms": k4_plain,
                              "library_ms": k4_lib, "bound_ms": bound[0], "bound_by": bound[1],
                              "bytes": bound[2], "ops": bound[3], "max_abs_err": k4_err})
            m = stability_max(csr, el, er, GAT_SLOPE)
            # K8 with the aux outputs (a training step's) and without (a request's)
            outs = flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16, aux=True)
            plain_outs = flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16)
            torch.cuda.synchronize()
            stats = k8_agreement(outs, csr, el, er, m, fs, h, bf16, GAT_PLAIN_EDGE_BLOCK)
            stats_na = k8_agreement(plain_outs, csr, el, er, m, fs, h, bf16, GAT_PLAIN_EDGE_BLOCK)
            del plain_outs
            check(all(r <= KERNEL_TOL for _, r, _ in stats + stats_na),
                  f"K8 at H={h}, F={f} (full graph) disagrees: {stats}, {stats_na}")
            k8_err = max(a for a, _, _ in stats + stats_na)
            ms_aux = cuda_ms(lambda: flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16, aux=True),
                             iters=10, warmup=2)
            ms_na = cuda_ms(lambda: flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16), iters=10, warmup=2)
            plain_aux = cuda_ms(lambda: flash_gat_fwd_plain(csr, el, er, m, fs, h, GAT_SLOPE, bf16, True,
                                                            GAT_PLAIN_EDGE_BLOCK), iters=1, warmup=1)
            plain_na = cuda_ms(lambda: flash_gat_fwd_plain(csr, el, er, m, fs, h, GAT_SLOPE, bf16, False,
                                                           GAT_PLAIN_EDGE_BLOCK), iters=1, warmup=1)
            k8_lib = _library_k8_ms(csr, el, er, fs, h, e)
            b_aux, b_na = k8_bound(n, e, h, f, True), k8_bound(n, e, h, f, False)
            print(f"k8-main H={h} F={f}: aux {ms_aux:.3f} ms / no aux {ms_na:.3f} ms (plain {plain_aux:.1f} / "
                  f"{plain_na:.1f} ms, sparse.softmax + sparse.mm {k8_lib} ms, bound {b_aux[0]:.3f} / "
                  f"{b_na[0]:.3f} ms by {b_aux[1]}); full-graph " + "; ".join(
                      f"{nm} max_abs_err {a:.3e} (err/sum|terms| {r:.2e})"
                      for nm, (a, r, _) in zip(("out", "den", "u", "p"), stats)))
            for key, ms, plain_ms, b, aux in (("K8", ms_aux, plain_aux, b_aux, True),
                                              ("K8_serving", ms_na, plain_na, b_na, False)):
                out[key].append({"H": h, "F": f, "E": e, "N": n, "aux": aux, "ms": ms, "plain_ms": plain_ms,
                                 "library_ms": k8_lib, "bound_ms": b[0], "bound_by": b[1], "bytes": b[2],
                                 "ops": b[3], "max_abs_err": k8_err,
                                 "err_over_mass": max(r for _, r, _ in stats)})
            # K9 on the transpose, with a random cotangent of the output
            g = torch.randn(fs.shape, device=dev, generator=gen)
            gu, c = _node_cotangents(g, outs[0], outs[1], h)
            del g, outs
            dfs, dl = flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16)
            torch.cuda.synchronize()
            (dfs_a, dfs_r, _), (dl_a, dl_r, _) = k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, bf16,
                                                               GAT_PLAIN_EDGE_BLOCK)
            check(dfs_r <= KERNEL_TOL and dl_r <= KERNEL_TOL,
                  f"K9 at H={h}, F={f} (full graph) disagrees: dfs {dfs_r}, dl {dl_r}")
            del dfs, dl
            k9_ms = cuda_ms(lambda: flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16),
                            iters=10, warmup=2)
            k9_plain = cuda_ms(lambda: flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16,
                                                           GAT_PLAIN_EDGE_BLOCK), iters=1, warmup=1)
            b9 = k9_bound(n, e, h, f)
            print(f"k9-main H={h} F={f}: {k9_ms:.3f} ms (plain {k9_plain:.1f} ms, no library call, bound "
                  f"{b9[0]:.3f} ms by {b9[1]}); full-graph dfs max_abs_err {dfs_a:.3e} (err/sum|terms| "
                  f"{dfs_r:.2e}), dl max_abs_err {dl_a:.3e} (err/sum|terms| {dl_r:.2e})")
            out["K9"].append({"H": h, "F": f, "E": e, "N": n, "ms": k9_ms, "plain_ms": k9_plain,
                              "library_ms": None, "bound_ms": b9[0], "bound_by": b9[1], "bytes": b9[2],
                              "ops": b9[3], "dfs_max_abs_err": dfs_a, "dfs_err_over_mass": dfs_r,
                              "dl_max_abs_err": dl_a, "dl_err_over_mass": dl_r})
            worst["K4"] = max(worst["K4"], k4_err)
            worst["K8"] = max(worst["K8"], k8_err)
            worst["K9"] = max(worst["K9"], dfs_a, dl_a)
            del el, er, m, fs, gu, c, elmax
            torch.cuda.empty_cache()
    return out, worst


def phase_gat_training(dev, args, base):
    """The GAT trained on the full graph with Adam(5e-3): the fourth main
    path. Every step launches K4, K8 (with aux) and K9 twice each."""
    graph, feats, labels = base["graph"], base["feats"], base["labels"]
    model = build_gat(graph, "auto", dev, args.seed).train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(feats), labels)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.item()

    t = time.perf_counter()
    warm_loss = step()
    warm_s = time.perf_counter() - t
    losses, times, per_step = [], [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        before = read_counts()
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
    counts = read_counts()
    print(f"gat-train: warm step {warm_s:.3f} s (loss {warm_loss:.4f}); {TRAIN_STEPS} Adam steps, s per step "
          f"{[round(v, 4) for v in times]}, losses {[round(v, 4) for v in losses]}, launches {counts}")
    check(all(c == {"K1": 0, "K2": 0, "K4": 2, "K8": 2, "K9": 2} for c in per_step),
          f"a GAT training step launched {per_step}, expected K4, K8 and K9 twice each")
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "non-finite GAT training loss")
    check(losses[-1] < losses[0], f"the GAT loss did not fall over {TRAIN_STEPS} steps: {losses}")
    return {"model": model, "optimizer": opt, "step": step, "counts": counts,
            "record": {"warm_s": warm_s, "warm_loss": warm_loss, "step_s": times, "losses": losses,
                       "launches_per_step": per_step, "launches": counts}}


def phase_gat_vs_plain(dev, args, workdir):
    """The GAT at ``--scale 0.01``: logits and every parameter's gradient on
    the flash route (bf16 stream) against the vertex program (f32)."""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    x = torch.from_numpy(data.get_all_features()).to(dev)
    y = torch.from_numpy(data.get_all_targets()).to(dev)
    logits, grads = {}, {}
    for impl in ("auto", "torch"):
        model = build_gat(graph, impl, dev, args.seed)
        out = model(x)
        torch.nn.functional.cross_entropy(out, y).backward()
        logits[impl] = out.detach()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        del model, out
    err = (logits["auto"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    ok = err <= MODEL_TOL * scale
    print(f"gat-model-check scale 0.01 (N={n}, E={graph.get_num_edges()}): flash route vs the vertex program "
          f"max_abs_err {err:.3e} (max |plain| {scale:.3f}, tol {MODEL_TOL:g} x that) {'ok' if ok else 'FAIL'}")
    check(ok, "the GAT's logits on the flash route disagree with the plain path at scale 0.01")
    worst, rows = 0.0, []
    for k, ref in grads["torch"].items():
        gerr = (grads["auto"][k] - ref).abs().max().item()
        ratio = gerr / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        rows.append({"tensor": k, "max_abs_err": gerr, "err_over_max": ratio})
        print(f"gat-grad-check {k}: flash route vs plain path max_abs_err {gerr:.3e}, {ratio:.2e} of the "
              f"largest (tol {GRAD_TOL:g}) {'ok' if ratio <= GRAD_TOL else 'FAIL'}")
    check(worst <= GRAD_TOL, "a GAT gradient on the flash route disagrees with the plain path at scale 0.01")
    return {"n": n, "e": graph.get_num_edges(), "max_abs_err": err, "max_abs_plain": scale, "grads": rows,
            "worst_grad_err_over_max": worst}


def phase_pubmed_gat(dev, args, workdir):
    """``benchmarking/gat/train.py --dataset pubmed`` on the port: 8 heads x
    8 hidden, 1 output head, Adam(5e-3), 200 full-graph epochs, the flash
    route (88,648 edges: an f32 stream)."""
    from stgraph_tpu_torch.dataset import PubmedDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.utils import accuracy

    STGraphDataset._offline = True  # no network here: the synthetic Pubmed, without a download attempt
    t = time.perf_counter()
    pubmed = PubmedDataLoader(cache_dir=os.path.join(workdir, "datasets"))
    data_s = time.perf_counter() - t
    n = pubmed.gdata["num_nodes"]
    graph = StaticGraph(pubmed.get_edges(), None, n, device=dev)
    x = torch.from_numpy(pubmed.get_all_features()).to(dev)
    y = torch.from_numpy(pubmed.get_all_targets()).to(dev)
    # The layers' own initialiser, as train.py uses its package's, drawn on
    # the CPU from --seed so that the draw does not depend on the device
    gen = torch.Generator().manual_seed(args.seed)
    model = GAT(graph, PUBMED_DIMS, PUBMED_HEADS, "auto", torch.device("cpu"), gen).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    reset_counts()
    times = []
    for epoch in range(PUBMED_EPOCHS):
        t = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        if epoch >= 3:
            times.append(time.perf_counter() - t)
    counts = read_counts()
    with torch.inference_mode():
        acc = accuracy(model(x), y)
    epoch_s = float(np.mean(times))
    print(f"pubmed-gat: synthetic={pubmed.synthetic} N={n} E={pubmed.gdata['num_edges']} (data {data_s:.1f} s), "
          f"{PUBMED_EPOCHS} epochs, mean epoch (>=3) {epoch_s * 1e3:.3f} ms, final loss {loss.item():.4f}, "
          f"train acc {acc:.4f} (floor {PUBMED_ACC_FLOOR:.4f}), launches {counts}")
    check(counts == {"K1": 0, "K2": 0, "K4": 2 * PUBMED_EPOCHS, "K8": 2 * PUBMED_EPOCHS, "K9": 2 * PUBMED_EPOCHS},
          f"Pubmed GAT launched {counts}")
    check(acc >= PUBMED_ACC_FLOOR, f"Pubmed GAT train accuracy {acc:.4f} is below {PUBMED_ACC_FLOOR:.4f}")
    return {"synthetic": pubmed.synthetic, "epoch_s": epoch_s, "train_acc": acc, "loss": loss.item(),
            "launches": counts, "data_s": data_s}


def kernel_entry(name, source, replaces, key, by_path, max_abs_err, per_launch, library=None):
    """One kernel's entry of the kernels line: launches summed over the main
    paths' runs, times summed over the launches of one request (K1, K4) or
    one training step (K2, K8 with its aux outputs, K9) at the main path's
    shapes."""
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(counts[key] for counts in by_path.values()),
        "launches_by_path": {path: counts[key] for path, counts in by_path.items()},
        "max_abs_err": max_abs_err,
        "ms": sum(p["ms"] for p in per_launch),
        "plain_ms": sum(p["plain_ms"] for p in per_launch),
        "bound_ms": sum(p["bound_ms"] for p in per_launch),
        "bound_by": "bytes" if all(p["bound_by"] == "bytes" for p in per_launch) else "operations",
        "library_ms": (None if any(p["library_ms"] is None for p in per_launch)
                       else sum(p["library_ms"] for p in per_launch)),
        "library": library,
        "per_launch": [{k: p[k] for k in ("H", "F", "aux", "ms", "plain_ms", "bound_ms", "library_ms") if k in p}
                       for p in per_launch],
    }


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
        record["k2_checks"] = phase_k2_vs_plain(dev, rng)
        record["gat_checks"] = phase_gat_kernels_vs_plain(dev, rng)
        with tempfile.TemporaryDirectory(dir=build_root) as workdir:
            served = phase_serving(dev, args, workdir)
            record["serving"] = served["record"]
            k1_launch, k1_err = phase_k1_at_main_shapes(served)
            record["k1_main"] = k1_launch
            record["profile"] = phase_profile(lambda: served["predictor"](served["feats"]), "one request")
            k2_launch, k2_err, record["k2_setup"] = phase_k2_at_main_shapes(served)
            record["k2_main"] = k2_launch
            trained = phase_training(dev, args, served)
            record["training"] = trained["record"]
            record["checkpoint_serve"] = phase_checkpoint_serve(dev, served, trained, workdir)
            record["training_profile"] = phase_profile(trained["step"], "one training step")
            record["unweighted_step"] = phase_unweighted_step(dev, args, served)
            # The GAT phases run on the graph the GCN phases built; the GCN
            # models, predictors and optimizer states go first.
            base = {k: served[k] for k in ("graph", "feats", "labels")}
            gcn_counts = served["counts"]
            del served, trained
            torch.cuda.empty_cache()
            gat = phase_gat_serving(dev, args, base)
            record["gat_serving"] = gat["record"]
            gat_launch, gat_err = phase_gat_kernels_at_main_shapes(dev, gat)
            record["gat_main"] = gat_launch
            del gat
            torch.cuda.empty_cache()
            gat_trained = phase_gat_training(dev, args, base)
            record["gat_training"] = gat_trained["record"]
            record["gat_training_profile"] = phase_profile(gat_trained["step"], "one GAT training step")
            gat_train_counts = gat_trained["counts"]
            del base, gat_trained
            torch.cuda.empty_cache()
            record["model_check"] = phase_model_vs_plain(dev, args, workdir)
            record["grad_check"] = phase_grads_vs_plain(dev, args, workdir)
            record["gat_check"] = phase_gat_vs_plain(dev, args, workdir)
            record["cora"] = phase_cora(dev, args, workdir)
            record["pubmed_gat"] = phase_pubmed_gat(dev, args, workdir)
        record["tgcn"] = phase_tgcn(dev, rng)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    by_path = {"serving": gcn_counts, "training": record["training"]["launches"],
               "gat-serving": record["gat_serving"]["launches"], "gat-training": gat_train_counts}
    kernels = [
        kernel_entry("spmm_rowmask (K1)", "stgraph_tpu_torch/csrc/spmm_rowmask.cu",
                     "stgraph_tpu/ops/segment_pallas.py:761", "K1", by_path,
                     max(record["k1_checks"]["max_abs_err"], k1_err), k1_launch),
        kernel_entry("spmm_sddmm_rowmask (K2)", "stgraph_tpu_torch/csrc/spmm_sddmm_rowmask.cu",
                     "stgraph_tpu/ops/segment_pallas.py:1248", "K2", by_path,
                     max(record["k2_checks"]["max_abs_err"], k2_err),
                     # a training step's three launches: F = 128, 128, 47
                     [p for f in (128, 128, 47) for p in k2_launch if p["F"] == f]),
        kernel_entry("segment_max_narrow (K4)", "stgraph_tpu_torch/csrc/segment_max_narrow.cu",
                     "stgraph_tpu/ops/segment_pallas.py:235", "K4", by_path,
                     max(record["gat_checks"]["max_abs_err"]["K4"], gat_err["K4"]), gat_launch["K4"],
                     "torch.segment_reduce(max) over the gathered (E, H) plane"),
        kernel_entry("flash_gat_fwd (K8)", "stgraph_tpu_torch/csrc/flash_gat_fwd.cu",
                     "stgraph_tpu/ops/flash_gat.py:191", "K8", by_path,
                     max(record["gat_checks"]["max_abs_err"]["K8"], gat_err["K8"]), gat_launch["K8"],
                     "torch.sparse.softmax + torch.sparse.mm, per head"),
        kernel_entry("flash_gat_bwd (K9)", "stgraph_tpu_torch/csrc/flash_gat_bwd.cu",
                     "stgraph_tpu/ops/flash_gat.py:365", "K9", by_path,
                     max(record["gat_checks"]["max_abs_err"]["K9"], gat_err["K9"]), gat_launch["K9"]),
    ]
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
