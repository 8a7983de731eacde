#!/usr/bin/env python3
"""Time K8 and K9 (the flash-GAT attention forward and backward) of the
PyTorch/CUDA port on one NVIDIA GPU in all their modes, with their parts
apart, on both node orders of the synthetic ogbn-products graph (the
loader's ids, and the label-propagation order of
``OgbNodeDataLoader(reorder=True)``), at the GAT's layers of
``chip_smoke.py``: 8 x 32 and 1 x 47 with a bf16 stream; K8 with the aux
outputs (a training step's), without (a request's) and in the dropout mode
at 0.6, K9 with and without dropout.

Phases (``--only``):

- ``parts``: the first design's parts, built from ``--baseline-csrc`` (a
  copy of the first design's ``flash_gat_fwd.cu``, ``flash_gat_bwd.cu``
  and ``edge_keep_mask.cuh``): the whole wrapper, the kernel alone,
  ``k8_k9_parts.cu``'s probes of its weight phase alone (the weights formed
  and ``den`` written, no row gathered) and of its row walk alone (constant
  weights, no ``el`` or ``fields`` read), and the wrapper's parts: the bf16
  cast and pad of the gathered table, K9's ``fields`` concatenation and the
  ``index_fill_`` of split rows.
- ``turns``: the first design and the port's K8 and K9, each through its
  whole wrapper, timed in turns (first, port, port, first) at every shape
  above on both orders, on the synthetic Pubmed at 8 x 8 and 1 x 3 (f32)
  and at ``dist_gat_attention``'s 4 x 32 on the distribution driver's
  default graph; every output held against the plain version, the bound
  beside.
- ``chunks``: the port's K8 (aux) and K9 at work items of 128, 256, 512
  and 1024 edges (``FLASH_CHUNK``), swept up then down, at both shapes.
- ``variants``: the port's K8 and K9 taken apart, each of ``VARIANTS``
  (``--variants``) built from an edited copy of the sources: the ring's
  depth and the round's length, chosen by measurement, and the parts of
  the design (without its products, weights or field copies); registers
  and spills of the main paths' instances, and each build's K8 and K9 at
  both shapes in turns.
- ``sass``: the port's and the first design's four libraries (with and
  without the dropout mode) built side by side with ``-Xptxas -v``: the
  build's wall time, registers and spills of every instance, written with
  the port's SASS (``cuobjdump -sass``) to ``--sass-dir``.

    python3 benchmarking/micro/k8_k9_bench.py [--only parts,turns,chunks,variants,sass]
        [--baseline-csrc DIR] [--orders base,reordered] [--out PATH] [--sass-dir DIR]

Inputs are random from a seed (a kernel's time does not depend on the
values). It prints one line per measurement and, last, the card's name and
power limit; ``--out`` writes every number as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.nn.functional as F

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (the graphs' scales, bounds, timers and checks of the smoke run)
import k1_bench as kb  # noqa: E402  (the ogbn graphs of both orders, record, turns)

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FIRST_CHUNK = 1024  # the first design's items
SHAPES = ((8, 32), (1, 47))  # the GAT's layers: (H, F)
SLOPE = cs.GAT_SLOPE
RATE = cs.GAT_ATTN_DROP
BUILD_DIR = os.path.join(ROOT, "build", "k8_k9_bench")
# the first design's C entries (stgraph_tpu_torch/ops/flash_gat.py before the redesign)
FIRST_FWD = [_VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _I, _VP,
             _F, _F, _VP]
FIRST_BWD = [_VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _F, _I, _VP, _F, _F, _VP]
record = kb.record


def nvcc_many(jobs):
    """Compile ``jobs`` ({name: (source, extra flags)}) into
    ``build/k8_k9_bench/<name>.so``, all at once; per name the library path,
    the compiler's messages and the wall seconds of its nvcc."""
    from stgraph_tpu_torch.ops import kernel_lib

    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name, (source, extra) in jobs.items():
        out = os.path.join(BUILD_DIR, f"{name}.so")
        cmd = [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, *extra, "-o", out, source]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out,
                       time.perf_counter())
    done = {}
    for name, (proc, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}: {log}")
        done[name] = (out, log, time.perf_counter() - t0)
    return done


class First:
    """The first design of K8 and K9, built from ``--baseline-csrc``, called
    as its wrappers called them: 1024-edge items, split rows zeroed, a bf16
    table with its row stride padded to 8; and its probes."""

    def __init__(self, csrc):
        fwd, bwd = os.path.join(csrc, "flash_gat_fwd.cu"), os.path.join(csrc, "flash_gat_bwd.cu")
        drop = ["-DSTG_DROPOUT_MODE=1"]
        built = nvcc_many({"first_fwd": (fwd, []), "first_fwd_dropout": (fwd, drop), "first_bwd": (bwd, []),
                           "first_bwd_dropout": (bwd, drop),
                           "k8_k9_parts": (os.path.join(HERE, "k8_k9_parts.cu"), [])})
        self.libs = {}
        for name, (path, _, _) in built.items():
            lib = ctypes.CDLL(path)
            for fn, argtypes in (("stg_flash_gat_fwd", FIRST_FWD), ("stg_flash_gat_bwd", FIRST_BWD),
                                 ("stg_k8_probe", [_VP] * 8 + [_I] + [_VP] * 4 + [_I, _I, _I, _F, _I, _I, _VP]),
                                 ("stg_k9_probe", [_VP] * 8 + [_I] + [_VP] * 2 + [_I, _I, _I, _F, _I, _I, _VP])):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
            self.libs[name] = lib

    @staticmethod
    def table(x, bf16):
        f = x.shape[1]
        if not bf16:
            return x.contiguous(), f
        ld = -(-f // 8) * 8
        t = x.to(torch.bfloat16)
        return (F.pad(t, (0, ld - f)) if ld != f else t.contiguous()), ld

    @staticmethod
    def items(csr):
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        return _work_items(csr, FIRST_CHUNK)

    def fwd_launch(self, csr, el, er, m, table, ld, bf16, outs, h, rate=0.0, seed=None):
        item_row, item_beg, split = self.items(csr)
        out, den, u, p = outs
        lib = self.libs["first_fwd_dropout" if rate else "first_fwd"]
        rc = lib.stg_flash_gat_fwd(
            csr.indptr.data_ptr(), csr.cols.data_ptr(), el.data_ptr(), er.data_ptr(), m.data_ptr(), table.data_ptr(),
            int(bf16), item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), split.data_ptr(), split.numel(),
            out.data_ptr(), den.data_ptr(), None if u is None else u.data_ptr(), None if p is None else p.data_ptr(),
            h, out.shape[1] // h, ld, SLOPE, FIRST_CHUNK, None if seed is None else seed.data_ptr(), rate,
            float(np.float32(1.0 / (1.0 - rate))), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def fwd(self, csr, el, er, m, fs, h, bf16, aux, rate=0.0, seed=None):
        """The whole first wrapper: table, outputs, zeroed split rows, kernel."""
        table, ld = self.table(fs, bf16)
        n, hf = fs.shape
        outs = self.fwd_outputs(n, hf, h, aux, fs.device)
        self.zero_split(csr, outs)
        self.fwd_launch(csr, el, er, m, table, ld, bf16, outs, h, rate, seed)
        return outs

    @staticmethod
    def fwd_outputs(n, hf, h, aux, dev):
        out = torch.empty(n, hf, device=dev)
        den = torch.empty(n, h, device=dev)
        return out, den, (torch.empty_like(out) if aux else None), (torch.empty_like(den) if aux else None)

    def zero_split(self, csr, outs):
        split = self.items(csr)[2]
        if split.numel():
            for t in outs:
                if t is not None:
                    t.index_fill_(0, split, 0.0)

    def bwd_launch(self, csr_t, el, fields, table, ld, bf16, fs, outs, h, rate=0.0, seed=None):
        item_row, item_beg, _ = self.items(csr_t)
        dfs, dl = outs
        lib = self.libs["first_bwd_dropout" if rate else "first_bwd"]
        rc = lib.stg_flash_gat_bwd(
            csr_t.indptr.data_ptr(), csr_t.cols.data_ptr(), el.data_ptr(), fields.data_ptr(), table.data_ptr(),
            int(bf16), fs.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), dfs.data_ptr(),
            dl.data_ptr(), h, dfs.shape[1] // h, ld, SLOPE, FIRST_CHUNK, None if seed is None else seed.data_ptr(),
            rate, float(np.float32(1.0 / (1.0 - rate))), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def bwd(self, csr_t, el, er, m, c, gu, fs, h, bf16, rate=0.0, seed=None):
        table, ld = self.table(gu, bf16)
        fields = torch.cat([er, m, c], 1).contiguous()
        n, hf = gu.shape
        outs = (torch.empty(n, hf, device=gu.device), torch.empty(n, h, device=gu.device))
        self.zero_split(csr_t, outs)
        self.bwd_launch(csr_t, el, fields, table, ld, bf16, fs, outs, h, rate, seed)
        return outs

    def k8_probe(self, csr, el, er, m, table, ld, outs, h, phase):
        item_row, item_beg, _ = self.items(csr)
        out, den, u, p = outs
        rc = self.libs["k8_k9_parts"].stg_k8_probe(
            csr.indptr.data_ptr(), csr.cols.data_ptr(), el.data_ptr(), er.data_ptr(), m.data_ptr(), table.data_ptr(),
            item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), out.data_ptr(), den.data_ptr(),
            None if u is None else u.data_ptr(), None if p is None else p.data_ptr(), h, out.shape[1] // h, ld,
            SLOPE, FIRST_CHUNK, phase, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def k9_probe(self, csr_t, el, fields, table, ld, fs, outs, h, phase):
        item_row, item_beg, _ = self.items(csr_t)
        dfs, dl = outs
        rc = self.libs["k8_k9_parts"].stg_k9_probe(
            csr_t.indptr.data_ptr(), csr_t.cols.data_ptr(), el.data_ptr(), fields.data_ptr(), table.data_ptr(),
            fs.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), dfs.data_ptr(), dl.data_ptr(),
            h, dfs.shape[1] // h, ld, SLOPE, FIRST_CHUNK, phase, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc


def gat_inputs(csr, h, f, gen):
    """A GAT layer's scores and features on ``csr``, the stability max (K4)
    and random node-level cotangent inputs gu and c for K9."""
    from stgraph_tpu_torch.ops.flash_gat import stability_max

    n, dev = csr.num_nodes, csr.device
    el, er = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
    fs, gu = (torch.randn(n, h * f, device=dev, generator=gen) for _ in range(2))
    c = torch.randn(n, h, device=dev, generator=gen)
    return el, er, fs, stability_max(csr, el, er, SLOPE), gu, c


def worst_rel(stats):
    return max(r for _, r, _ in stats)


def phase_parts(dev, args, first):
    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    bf16 = True
    seed = torch.tensor([12345], device=dev)
    for order in args.orders:
        graph = kb.ogbn(dev, args, order)
        csr = graph.fwd_csr
        csr_t = csr.transpose()
        n = csr.num_nodes
        with torch.inference_mode():
            for h, f in SHAPES:
                hf = h * f
                el, er, fs, m, gu, c = gat_inputs(csr, h, f, gen)
                row = dict(phase="parts", order=order, H=h, F=f, stream="bf16")
                row["cast_pad_ms"] = cs.cuda_ms(lambda: first.table(fs, bf16), 10)
                row["fields_cat_ms"] = cs.cuda_ms(lambda: torch.cat([er, m, c], 1).contiguous(), 10)
                split, split_t = first.items(csr)[2], first.items(csr_t)[2]
                row["split_rows"], row["split_rows_t"] = split.numel(), split_t.numel()
                outs = first.fwd_outputs(n, hf, h, True, dev)
                row["k8_index_fill_ms"] = cs.cuda_ms(lambda: first.zero_split(csr, outs), 10)
                bouts = (torch.empty(n, hf, device=dev), torch.empty(n, h, device=dev))
                row["k9_index_fill_ms"] = cs.cuda_ms(lambda: first.zero_split(csr_t, bouts), 10)
                table, ld = first.table(fs, bf16)
                gtable, _ = first.table(gu, bf16)
                fields = torch.cat([er, m, c], 1).contiguous()
                # the first design's outputs against the plain version
                torch.cuda.empty_cache()
                row["k8_err"] = worst_rel(cs.k8_agreement(first.fwd(csr, el, er, m, fs, h, bf16, True), csr, el,
                                                          er, m, fs, h, torch.bfloat16, cs.GAT_PLAIN_EDGE_BLOCK))
                torch.cuda.empty_cache()
                dfs, dl = first.bwd(csr_t, el, er, m, c, gu, fs, h, bf16)
                (_, r1, _), (_, r2, _) = cs.k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, torch.bfloat16,
                                                         cs.GAT_PLAIN_EDGE_BLOCK)
                row["k9_err"] = max(r1, r2)
                del dfs, dl
                torch.cuda.empty_cache()
                na = first.fwd_outputs(n, hf, h, False, dev)
                timings = {
                    "k8_aux_wrapper_ms": lambda: first.fwd(csr, el, er, m, fs, h, bf16, True),
                    "k8_aux_kernel_ms": lambda: first.fwd_launch(csr, el, er, m, table, ld, bf16, outs, h),
                    "k8_aux_weights_ms": lambda: first.k8_probe(csr, el, er, m, table, ld, outs, h, 1),
                    "k8_aux_rows_ms": lambda: first.k8_probe(csr, el, er, m, table, ld, outs, h, 2),
                    "k8_aux_probe_whole_ms": lambda: first.k8_probe(csr, el, er, m, table, ld, outs, h, 0),
                    "k8_wrapper_ms": lambda: first.fwd(csr, el, er, m, fs, h, bf16, False),
                    "k8_kernel_ms": lambda: first.fwd_launch(csr, el, er, m, table, ld, bf16, na, h),
                    "k8_weights_ms": lambda: first.k8_probe(csr, el, er, m, table, ld, na, h, 1),
                    "k8_rows_ms": lambda: first.k8_probe(csr, el, er, m, table, ld, na, h, 2),
                    "k8_dropout_wrapper_ms": lambda: first.fwd(csr, el, er, m, fs, h, bf16, True, RATE, seed),
                    "k8_dropout_kernel_ms": lambda: first.fwd_launch(csr, el, er, m, table, ld, bf16, outs, h, RATE,
                                                                     seed),
                    "k9_wrapper_ms": lambda: first.bwd(csr_t, el, er, m, c, gu, fs, h, bf16),
                    "k9_kernel_ms": lambda: first.bwd_launch(csr_t, el, fields, gtable, ld, bf16, fs, bouts, h),
                    "k9_weights_ms": lambda: first.k9_probe(csr_t, el, fields, gtable, ld, fs, bouts, h, 1),
                    "k9_rows_ms": lambda: first.k9_probe(csr_t, el, fields, gtable, ld, fs, bouts, h, 2),
                    "k9_probe_whole_ms": lambda: first.k9_probe(csr_t, el, fields, gtable, ld, fs, bouts, h, 0),
                    "k9_dropout_wrapper_ms": lambda: first.bwd(csr_t, el, er, m, c, gu, fs, h, bf16, RATE, seed),
                    "k9_dropout_kernel_ms": lambda: first.bwd_launch(csr_t, el, fields, gtable, ld, bf16, fs, bouts,
                                                                     h, RATE, seed),
                }
                for key, fn in timings.items():
                    row[key] = cs.cuda_ms(fn, 10, warmup=2)
                row["k8_aux_bound_ms"] = cs.k8_bound(n, csr.num_edges, h, f, True)[0]
                row["k9_bound_ms"] = cs.k9_bound(n, csr.num_edges, h, f)[0]
                record(**row)
                del el, er, fs, m, gu, c, table, gtable, fields, outs, bouts, na
                torch.cuda.empty_cache()


def _turn_case(label, order, csr, csr_t, h, f, bf16, gen, first, dev, iters=10):
    """K8 (aux, no aux, dropout) and K9 (with and without dropout) of both
    designs in turns at one shape, each output against the plain version."""
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd

    n, e = csr.num_nodes, csr.num_edges
    stream = torch.bfloat16 if bf16 else torch.float32
    seed = torch.tensor([987654321], device=dev)
    el, er, fs, m, gu, c = gat_inputs(csr, h, f, gen)
    cases = (
        ("K8 aux", True, 0.0),
        ("K8", False, 0.0),
        ("K8 dropout", True, RATE),
        ("K9", None, 0.0),
        ("K9 dropout", None, RATE),
    )
    for kernel, aux, rate in cases:
        torch.cuda.empty_cache()
        sd = seed if rate else None
        if aux is not None:
            new = lambda: flash_gat_fwd(csr, el, er, m, fs, h, SLOPE, stream, aux=aux, rate=rate, seed=sd)  # noqa
            old = lambda: first.fwd(csr, el, er, m, fs, h, bf16, aux, rate, sd)  # noqa: E731
            errs = [worst_rel(cs.k8_agreement(cs.poisoned_call((n, h * f), new), csr, el, er, m, fs, h, stream,
                                              cs.GAT_PLAIN_EDGE_BLOCK, rate, sd)),
                    worst_rel(cs.k8_agreement(old(), csr, el, er, m, fs, h, stream, cs.GAT_PLAIN_EDGE_BLOCK, rate,
                                              sd))]
            bound = cs.k8_bound(n, e, h, f, aux)[0]
        else:
            new = lambda: flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, SLOPE, stream, rate=rate, seed=sd)  # noqa
            old = lambda: first.bwd(csr_t, el, er, m, c, gu, fs, h, bf16, rate, sd)  # noqa: E731
            errs = []
            for res in (cs.poisoned_call((n, h * f), new), old()):
                stats = cs.k9_agreement(res[0], res[1], csr_t, el, er, m, c, gu, fs, h, stream,
                                        cs.GAT_PLAIN_EDGE_BLOCK, rate, sd)
                errs.append(max(stats[0][1], stats[1][1]))
            bound = cs.k9_bound(n, e, h, f)[0]
        torch.cuda.synchronize()
        for err in errs:
            cs.check(err <= cs.KERNEL_TOL, f"{kernel} at {label} {h} x {f} disagrees with the plain version: {err}")
        (o1, o2), (n1, n2) = kb._turns(old, new, iters)
        record(phase="turns", order=order, kernel=kernel, H=h, F=f, stream="bf16" if bf16 else "f32", N=n, E=e,
               first_ms=[o1, o2], new_ms=[n1, n2], err_new=errs[0], err_first=errs[1], bound_ms=bound)
    del el, er, fs, m, gu, c
    torch.cuda.empty_cache()


def small_graphs(dev, args):
    """The synthetic Pubmed and the distribution driver's default graph."""
    from stgraph_tpu_torch.dataset import PubmedDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph

    STGraphDataset._offline = True
    pubmed = PubmedDataLoader(cache_dir=os.path.join(args.data_dir, "datasets"))
    d = cs.DIST_SMALL
    src, dst = cs.dist_train_data(args.seed, d["nodes"], d["edges"], d["feat"], d["hidden"], d["layers"],
                                  d["classes"])[:2]
    return {"pubmed": StaticGraph(pubmed.get_edges(), None, pubmed.gdata["num_nodes"], device=dev),
            "dist": StaticGraph(np.stack([src, dst], 1), None, d["nodes"], device=dev)}


def phase_turns(dev, args, first):
    from stgraph_tpu_torch.ops.spmm_cuda import _BF16_STREAM_MIN_EDGES

    gen = torch.Generator(device=dev).manual_seed(args.seed + 43)
    for order in args.orders:
        csr = kb.ogbn(dev, args, order).fwd_csr
        with torch.inference_mode():
            for h, f in SHAPES:
                _turn_case("ogbn", order, csr, csr.transpose(), h, f, True, gen, first, dev)
    graphs = small_graphs(dev, args)
    with torch.inference_mode():
        for name, tilings in (("pubmed", ((8, 8), (1, 3))), ("dist", (cs.DIST_GAT_TILING,))):
            csr = graphs[name].fwd_csr
            bf16 = csr.capacity >= _BF16_STREAM_MIN_EDGES
            for h, f in tilings:
                _turn_case(name, name, csr, csr.transpose(), h, f, bf16, gen, first, dev, iters=50)


def phase_chunks(dev, args):
    from stgraph_tpu_torch.ops import spmm_kernels as SK
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd

    gen = torch.Generator(device=dev).manual_seed(args.seed + 47)
    saved = dict(SK.FLASH_CHUNK)
    bf16 = torch.bfloat16
    try:
        for order in args.orders:
            csr = kb.ogbn(dev, args, order).fwd_csr
            csr_t = csr.transpose()
            with torch.inference_mode():
                for h, f in SHAPES:
                    el, er, fs, m, gu, c = gat_inputs(csr, h, f, gen)
                    for chunk in (128, 256, 512, 1024, 1024, 512, 256, 128):  # up, then down
                        SK.FLASH_CHUNK.update(fwd=chunk, bwd=chunk)
                        record(phase="chunks", order=order, H=h, F=f, chunk=chunk,
                               k8_aux_ms=cs.cuda_ms(lambda: flash_gat_fwd(csr, el, er, m, fs, h, SLOPE, bf16,
                                                                          aux=True), 10, warmup=2),
                               k9_ms=cs.cuda_ms(lambda: flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, SLOPE, bf16),
                                                10, warmup=2))
                    del el, er, fs, m, gu, c
                    torch.cuda.empty_cache()
    finally:
        SK.FLASH_CHUNK.update(saved)


# the main paths' instances: (stream, lanes an edge) of 8 x 32 and 1 x 47
# bf16, 4 x 32 bf16, Pubmed's 8 x 8 and 1 x 3 f32; one load a lane, one head
MAIN_GEOMETRIES = (("__nv_bfloat16", 32), ("__nv_bfloat16", 8), ("__nv_bfloat16", 16), ("float", 16), ("float", 1))
WALK = "flash_gat_walk.cuh"
BOUND = "constexpr int kMinBlocks = 2;"
# The port's design taken apart: (file, text, replacement) edits of a copy
# of csrc/ (none: the source as it stands)
VARIANTS = {
    "source": (),
    "ring_2": ((WALK, "constexpr int kStages = 3;", "constexpr int kStages = 2;"),),
    "ring_4": ((WALK, "constexpr int kStages = 3;", "constexpr int kStages = 4;"),),
    "round_x2": ((WALK, "kEps * 4 <= 32 ? 4 : 32 / kEps", "kEps * 8 <= 32 ? 8 : 32 / kEps"),),
    "round_x4": ((WALK, "kEps * 4 <= 32 ? 4 : 32 / kEps", "kEps * 16 <= 32 ? 16 : 32 / kEps"),),
    "no_products": tuple((fn, "walk.template madd<false>(q[s], v, acc);", "") for fn in
                         ("flash_gat_fwd.cu", "flash_gat_bwd.cu")) + (
        ("flash_gat_fwd.cu", "if (kAux) walk.template madd<true>(q[s], v, uacc);", ""),
        ("flash_gat_bwd.cu", "walk.madd_dot(q[s], xw, v, dla);", "")),
    "no_weights": tuple((fn, "if (walk.wh_ok() && e < W::kRound && e < cnt) {", "if (false) {")
                        for fn in ("flash_gat_fwd.cu", "flash_gat_bwd.cu")),
    "no_fields": ((WALK, "if (wh_ok() && e < kRound && e < cnt) {", "if (false) {"),),
    # the kernels' launch bound asking for at least 1 (no bound) or 3 blocks an SM
    "bounds_1": ((WALK, BOUND, "constexpr int kMinBlocks = 1;"),),
    "bounds_3": ((WALK, BOUND, "constexpr int kMinBlocks = 3;"),),
}


def main_path(name):
    return any(f"<{t}, (int){g}, (int)1, (bool)1" in name for t, g in MAIN_GEOMETRIES)


def phase_variants(dev, args):
    """The port's K8 and K9 taken apart: each of ``VARIANTS`` built from an
    edited copy of the sources (ring depth, round length, without the
    products, without the weights, without the field copies), its main-path
    instances' registers and spills, then K8 (with and without aux) and K9
    of each build through the port's wrappers at both shapes on the
    loader's order, in turns (each build, then again in reverse). Only
    "source" computes the function; the others time a part."""
    from stgraph_tpu_torch.ops import flash_gat as FG
    from stgraph_tpu_torch.ops import kernel_lib

    csrc = os.path.join(ROOT, "stgraph_tpu_torch", "csrc")
    names = [v for v in args.variants.split(",")]
    jobs = {}
    for name in names:
        d = os.path.join(BUILD_DIR, f"variant_{name}")
        os.makedirs(d, exist_ok=True)
        texts = {}
        for fn in os.listdir(csrc):
            with open(os.path.join(csrc, fn)) as fh:
                texts[fn] = fh.read()
        for fn, old, new in VARIANTS[name]:
            assert old in texts[fn], (name, fn, old)
            texts[fn] = texts[fn].replace(old, new)
        for fn, text in texts.items():
            with open(os.path.join(d, fn), "w") as fh:
                fh.write(text)
        for lib in ("flash_gat_fwd", "flash_gat_bwd"):
            jobs[f"{name}:{lib}"] = (os.path.join(d, f"{lib}.cu"), [])
    built = nvcc_many(jobs)
    libs = {}
    for job, (path, log, secs) in built.items():
        inst = ptxas_instances(log)
        dnames = demangle([i[0] for i in inst])
        main = [(regs, spill, nm[nm.index("<"):nm.index(">") + 1]) for (_, regs, spill), nm in zip(inst, dnames)
                if main_path(nm)]
        record(phase="variants", library=job, registers=sorted({r for r, _, _ in main}),
               spilling=[f"{nm} {sp} B" for _, sp, nm in main if sp])
        lib = ctypes.CDLL(path)
        for fn, sig in list(FG._FWD_SIGNATURES.items()) + list(FG._BWD_SIGNATURES.items()):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[job] = lib
    if not args.orders:  # registers and spills only
        return
    saved = {k: kernel_lib._loaded.get(k) for k in ("flash_gat_fwd", "flash_gat_bwd")}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 53)
    csr = kb.ogbn(dev, args, args.orders[0]).fwd_csr
    csr_t = csr.transpose()
    bf16 = torch.bfloat16
    try:
        with torch.inference_mode():
            for h, f in SHAPES:
                el, er, fs, m, gu, c = gat_inputs(csr, h, f, gen)
                calls = {"k8_aux": lambda: FG.flash_gat_fwd(csr, el, er, m, fs, h, SLOPE, bf16, aux=True),
                         "k8": lambda: FG.flash_gat_fwd(csr, el, er, m, fs, h, SLOPE, bf16),
                         "k9": lambda: FG.flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, SLOPE, bf16)}
                times = {}
                for name in names + names[::-1]:
                    kernel_lib._loaded["flash_gat_fwd"] = libs[f"{name}:flash_gat_fwd"]
                    kernel_lib._loaded["flash_gat_bwd"] = libs[f"{name}:flash_gat_bwd"]
                    for key, fn in calls.items():
                        times.setdefault(f"{key}:{name}", []).append(round(cs.cuda_ms(fn, 10, warmup=2), 4))
                record(phase="variants", order=args.orders[0], H=h, F=f, **times)
                del el, er, fs, m, gu, c
                torch.cuda.empty_cache()
    finally:
        for k, v in saved.items():
            if v is None:
                kernel_lib._loaded.pop(k, None)
            else:
                kernel_lib._loaded[k] = v


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_instances(log):
    """(mangled kernel name, registers, spill store bytes) of every kernel in
    an nvcc -Xptxas -v log."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        if (mt := _ENTRY.search(line)):
            name, spill = mt.group(1), 0
        elif (mt := _SPILL.search(line)) and name:
            spill = int(mt.group(1))
        elif (mt := _USED.search(line)) and name:
            rows.append((name, int(mt.group(1)), spill))
            name = None
    return rows


def demangle(names):
    from stgraph_tpu_torch.ops import kernel_lib

    tool = os.path.join(os.path.dirname(kernel_lib._nvcc()), "cu++filt")
    if not os.path.exists(tool):
        return list(names)
    proc = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    out = proc.stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def phase_sass(dev, args):
    from stgraph_tpu_torch.ops import kernel_lib

    os.makedirs(args.sass_dir, exist_ok=True)
    csrc = os.path.join(ROOT, "stgraph_tpu_torch", "csrc")
    drop = ["-DSTG_DROPOUT_MODE=1"]
    designs = {"port": csrc}
    if args.baseline_csrc:
        designs["first"] = args.baseline_csrc
    for design, d in designs.items():
        jobs = {f"{design}_{lib}{sfx}": (os.path.join(d, f"{lib}.cu"), flags)
                for lib in ("flash_gat_fwd", "flash_gat_bwd") for sfx, flags in (("", []), ("_dropout", drop))}
        t0 = time.perf_counter()
        built = nvcc_many(jobs)
        wall = time.perf_counter() - t0
        for name, (path, log, secs) in built.items():
            with open(os.path.join(args.sass_dir, f"{name}_ptxas.txt"), "w") as fh:
                fh.write(log)
            inst = ptxas_instances(log)
            names = demangle([i[0] for i in inst])
            with open(os.path.join(args.sass_dir, f"{name}_instances.txt"), "w") as fh:
                for (_, regs, spill), nm in zip(inst, names):
                    fh.write(f"{regs:4d} registers {spill:4d} B spilled  {nm}\n")
            record(phase="sass", library=name, nvcc_s=secs, instances=len(inst),
                   registers=[min((i[1] for i in inst), default=0), max((i[1] for i in inst), default=0)],
                   with_spills=sum(1 for i in inst if i[2]), max_spill_B=max((i[2] for i in inst), default=0))
            if design == "port" and "dropout" not in name:
                cuobjdump = os.path.join(os.path.dirname(kernel_lib._nvcc()), "cuobjdump")
                sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True).stdout
                with open(os.path.join(args.sass_dir, f"{name}_sass.txt"), "w") as fh:
                    fh.write(sass)
        record(phase="sass", design=design, parallel_build_s=wall)


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="parts,turns,chunks,sass", help="comma-separated phases")
    ap.add_argument("--baseline-csrc", help="a directory with the first design's flash_gat_fwd.cu, "
                                            "flash_gat_bwd.cu and edge_keep_mask.cuh (parts, turns, sass)")
    ap.add_argument("--orders", default="base,reordered", help="node orders of the ogbn graph")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated builds of the variants phase")
    ap.add_argument("--scale", type=float, default=1.0, help="synthetic ogbn-products scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the measurements as JSON here")
    ap.add_argument("--sass-dir", default=os.path.join(ROOT, "chiprun_out", "k8_k9_sass"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_k9_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    args.orders = [o for o in args.orders.split(",") if o]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    phases = args.only.split(",")
    first = First(args.baseline_csrc) if {"parts", "turns"} & set(phases) else None
    status = 0
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as data_dir:
        args.data_dir = data_dir
        for name in phases:
            t = time.perf_counter()
            try:
                if name in ("parts", "turns"):
                    globals()[f"phase_{name}"](dev, args, first)
                else:
                    globals()[f"phase_{name}"](dev, args)
            except Exception:  # a phase that fails does not take the others' numbers with it
                print(f"k8_k9_bench: {name} FAILED:\n{traceback.format_exc()}", flush=True)
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
