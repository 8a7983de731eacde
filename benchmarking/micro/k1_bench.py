#!/usr/bin/env python3
"""Time K1 (the row-wise SpMM) of the PyTorch/CUDA port on one NVIDIA GPU in
all its modes, with its parts apart, on both node orders of the synthetic
ogbn-products graph (the loader's ids, and the label-propagation order of
``OgbNodeDataLoader(reorder=True)``), at the main paths' shapes of
``chip_smoke.py``:

- one head with a bf16 stream at F = 128 and 47 (the GCN request's and
  step's layers, weighted; and on the transpose CSR, unweighted, as the
  GCN backward and JAX's ``bench_ogbn_spmm`` run it);
- the shard mode (``spmm_rowmask_traced``, f32, unweighted) at F = 64 and
  47 over the whole graph, the distributed step's interior CSR at P = 1;
- the heads mode with the denominator and the no-gather sum at 32 x 4 on
  the PPI-sized graph (bf16 stream) and on the synthetic Pubmed (f32).

Phases (``--only``):

- ``check``: the packed bf16 product K1 forms (``mul.rn.bf16x2``) against
  the first design's ``round_to_bf16(__fmul_rn(x, w))``, bit for bit over
  all 2^32 pairs of bf16 bit patterns (``stg_bf16_product_check``).
- ``parts``: the first design's parts, built from ``--baseline-csrc`` (a
  copy of the first design's ``spmm_rowmask.cu`` and
  ``segment_sum_wide.cu``): the wrapper's bf16 cast and pad, the
  ``index_fill_`` of split rows, the kernel alone, weighted and unweighted
  (a gather without the products), and ``k1_parts.cu``'s probe of its walk
  at one and two edges a step, with and without the products; and each
  order's ``gather_working_set`` at 256 B rows.
- ``turns``: the first design and the port's K1, each through its whole
  wrapper, timed in turns (first, port, port, first) at every shape above,
  each output held against the plain version; ``torch.sparse.mm`` (one
  block-diagonal call for the heads mode, ``segment_reduce`` for the
  no-gather sum) and the bound beside them.
- ``chunks``: the port's K1 at work items of 128, 256, 512 and 1024 edges
  (``K1_CHUNK``): the heads mode and the no-gather sum at 32 x 4 on PPI and
  Pubmed, one head at F = 128 bf16 and the shard mode at F = 64 f32 on the
  ogbn graph.
- ``stride``: the port's K1 alone (its C entry, no wrapper), f32,
  unweighted, at F = 47 on its own 188 B row stride, at F = 47 in a table
  padded to a 192 B stride, and at F = 64, in turns.
- ``sass``: the port's K1 built with ``-Xptxas -v`` (registers, spills per
  instantiation) and its SASS (``cuobjdump -sass``), written to ``--sass-dir``.

    python3 benchmarking/micro/k1_bench.py [--only check,parts,turns,chunks,stride,sass]
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
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (the graphs, bounds, timers and yardsticks of the smoke run)

RESULTS = []
_VP, _I = ctypes.c_void_p, ctypes.c_int
FIRST_CHUNK = 1024  # the first design's items, every mode


def record(**kw):
    RESULTS.append(kw)
    print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in kw.items()), flush=True)


def agree(out, ref, mass, rows=1 << 18):
    """Worst |out - ref| over the terms' mass, ``rows`` rows at a time."""
    worst = 0.0
    for r0 in range(0, out.shape[0], rows):
        err = (out[r0:r0 + rows] - ref[r0:r0 + rows]).abs()
        worst = max(worst, cs._err_over_mass(err, mass[r0:r0 + rows]))
    return worst


def nvcc_build(source, name, extra=()):
    """``source`` compiled into ``build/k1_bench/<name>.so``; the library and
    the compiler's messages."""
    from stgraph_tpu_torch.ops import kernel_lib

    out_dir = os.path.join(ROOT, "build", "k1_bench")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{name}.so")
    proc = subprocess.run([kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, *extra, "-o", out, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {source}: {proc.stdout}{proc.stderr}")
    return ctypes.CDLL(out), proc.stdout + proc.stderr


class First:
    """The first design of K1 and of its no-gather mode, built from
    ``--baseline-csrc``, called as its wrapper called it: items of 1024
    edges, split rows zeroed, a bf16 table with its row stride padded to 8."""

    def __init__(self, csrc):
        self.k1, _ = nvcc_build(os.path.join(csrc, "spmm_rowmask.cu"), "first_spmm_rowmask")
        self.k1.stg_spmm_rowmask.argtypes = [_VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _VP]
        self.wide, _ = nvcc_build(os.path.join(csrc, "segment_sum_wide.cu"), "first_segment_sum_wide")
        self.wide.stg_segment_sum_wide.argtypes = [_VP, _VP, _I, _VP, _VP, _I, _VP, _I, _I, _VP]
        self.probe, _ = nvcc_build(os.path.join(ROOT, "benchmarking", "micro", "k1_parts.cu"), "k1_parts")
        self.probe.stg_k1_probe.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _VP, _VP, _I, _VP, _I, _I, _I, _VP]

    @staticmethod
    def table(x, bf16):
        f = x.shape[1]
        if not bf16:
            return x.contiguous(), f
        ld = -(-f // 8) * 8
        t = x.to(torch.bfloat16)
        return (F.pad(t, (0, ld - f)) if ld != f else t.contiguous()), ld

    def launch(self, csr, w, table, ld, bf16, out, den=None, heads=1):
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        item_row, item_beg, _ = _work_items(csr, FIRST_CHUNK)
        rc = self.k1.stg_spmm_rowmask(
            csr.indptr.data_ptr(), csr.cols.data_ptr(), None if w is None else w.data_ptr(), table.data_ptr(),
            int(bf16), item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), out.data_ptr(),
            None if den is None else den.data_ptr(), out.shape[1], ld, heads, FIRST_CHUNK,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def spmm(self, csr, w, x, bf16, heads=1, with_denom=False):
        """The whole first wrapper: table, outputs, zeroed split rows, kernel."""
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        table, ld = self.table(x, bf16)
        out = torch.empty(csr.num_nodes, x.shape[1], device=x.device)
        den = torch.empty(csr.num_nodes, heads, device=x.device) if with_denom else None
        split = _work_items(csr, FIRST_CHUNK)[2]
        if split.numel():
            out.index_fill_(0, split, 0.0)
            if den is not None:
                den.index_fill_(0, split, 0.0)
        self.launch(csr, None if w is None else w.reshape(-1).float().contiguous(), table, ld, bf16, out, den,
                    heads)
        return out, den

    def nogather(self, csr, vals, round_bf16):
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        item_row, item_beg, split = _work_items(csr, FIRST_CHUNK)
        out = torch.empty(csr.num_nodes, vals.shape[1], device=vals.device)
        if split.numel():
            out.index_fill_(0, split, 0.0)
        rc = self.wide.stg_segment_sum_wide(
            csr.indptr.data_ptr(), vals.data_ptr(), int(round_bf16), item_row.data_ptr(), item_beg.data_ptr(),
            item_row.numel(), out.data_ptr(), vals.shape[1], FIRST_CHUNK, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out

    def walk(self, csr, w, table, ld, bf16, out, edges):
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        item_row, item_beg, _ = _work_items(csr, FIRST_CHUNK)
        rc = self.probe.stg_k1_probe(
            csr.indptr.data_ptr(), csr.cols.data_ptr(), None if w is None else w.data_ptr(), table.data_ptr(),
            int(bf16), edges, item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), out.data_ptr(),
            out.shape[1], ld, FIRST_CHUNK, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc


_GRAPHS = {}


def ogbn(dev, args, order):
    """The synthetic ogbn-products graph of ``chip_smoke.py`` on the
    loader's ids (``base``) or in its locality order (``reordered``), built
    once a run; the reorder's host seconds and the order's working set."""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.graph.reorder import gather_working_set

    if order not in _GRAPHS:
        t = time.perf_counter()
        data = OgbNodeDataLoader(root=args.data_dir, scale=args.scale, seed=args.seed,
                                 reorder=order == "reordered")
        load_s = time.perf_counter() - t
        n = data.gdata["num_nodes"]
        graph = StaticGraph(data.get_edges(), None, n, device=dev)
        del data
        csr = graph.fwd_csr
        _, rows, cols, _ = csr.host_arrays()
        e = csr.num_edges
        ws = gather_working_set(rows[:e], cols[:e], n, row_bytes=256)
        _ = graph.bwd_csr
        torch.cuda.synchronize()
        record(phase="graph", order=order, N=n, E=e, load_s=load_s, working_set_256B=ws,
               total_s=time.perf_counter() - t)
        _GRAPHS[order] = graph
    return _GRAPHS[order]


def small_graphs(dev, args):
    """The PPI-sized graph (bf16 stream) and the synthetic Pubmed (f32)."""
    from stgraph_tpu_torch.dataset import PubmedDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph

    if "ppi" not in _GRAPHS:
        _GRAPHS["ppi"] = cs.ppi_graph(dev, args.seed)[0]
        STGraphDataset._offline = True
        pubmed = PubmedDataLoader(cache_dir=os.path.join(args.data_dir, "datasets"))
        _GRAPHS["pubmed"] = StaticGraph(pubmed.get_edges(), None, pubmed.gdata["num_nodes"], device=dev)
    return {"ppi": _GRAPHS["ppi"], "pubmed": _GRAPHS["pubmed"]}


def ogbn_shapes():
    """(label, csr attribute, F, stream, weighted, mode) of the ogbn shapes."""
    return (
        ("one head fwd", "fwd_csr", 128, "bf16", True, "one_head"),
        ("one head fwd", "fwd_csr", 47, "bf16", True, "one_head"),
        ("one head transpose", "bwd_csr", 128, "bf16", False, "one_head"),
        ("one head transpose", "bwd_csr", 47, "bf16", False, "one_head"),
        ("shard mode", "fwd_csr", 64, "f32", False, "shard"),
        ("shard mode", "fwd_csr", 47, "f32", False, "shard"),
    )


def phase_check(dev, args):
    from stgraph_tpu_torch.ops import kernel_lib
    from stgraph_tpu_torch.ops.spmm_kernels import _SIGNATURES

    lib = kernel_lib.load("spmm_rowmask", _SIGNATURES)
    res = torch.tensor([0, 0, -1], dtype=torch.int64, device=dev)  # -1: 2^64 - 1 as u64
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    assert lib.stg_bf16_product_check(0, 1 << 32, res.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    stop.record()
    torch.cuda.synchronize()
    bad, nans, first = res.tolist()
    record(phase="check", pairs=1 << 32, mismatches=bad, nan_pairs=nans,
           first_mismatch=None if first == -1 else hex(first & (2**64 - 1)), ms=start.elapsed_time(stop))
    cs.check(bad == 0, f"the packed bf16 product differs from the first design's in {bad} pairs")


def phase_parts(dev, args, first):
    from stgraph_tpu_torch.ops.spmm_kernels import _work_items, spmm_rowmask_plain

    gen = torch.Generator(device=dev).manual_seed(args.seed + 23)
    for order in args.orders:
        graph = ogbn(dev, args, order)
        n = graph.fwd_csr.num_nodes
        with torch.inference_mode():
            for f, bf16 in ((128, True), (47, True), (64, False), (47, False)):
                csr = graph.fwd_csr
                x = torch.randn(n, f, device=dev, generator=gen)
                w = torch.rand(csr.capacity, device=dev, generator=gen)
                stream = torch.bfloat16 if bf16 else torch.float32
                row = dict(phase="parts", order=order, F=f, stream="bf16" if bf16 else "f32")
                row["cast_pad_ms"] = cs.cuda_ms(lambda: first.table(x, bf16), 10) if bf16 else 0.0
                split = _work_items(csr, FIRST_CHUNK)[2]
                out = torch.empty(n, f, device=dev)
                row["split_rows"] = split.numel()
                row["index_fill_ms"] = cs.cuda_ms(lambda: out.index_fill_(0, split, 0.0), 10)
                table, ld = first.table(x, bf16)
                ref = spmm_rowmask_plain(csr, w, x, stream, cs.PLAIN_EDGE_BLOCK)
                mass = spmm_rowmask_plain(csr, w, x.abs(), stream, cs.PLAIN_EDGE_BLOCK)
                out.index_fill_(0, split, 0.0)
                first.launch(csr, w, table, ld, bf16, out)
                torch.cuda.synchronize()
                row["err"] = agree(out, ref, mass)
                row["whole_wrapper_ms"] = cs.cuda_ms(lambda: first.spmm(csr, w, x, bf16), 10)
                row["kernel_ms"] = cs.cuda_ms(lambda: first.launch(csr, w, table, ld, bf16, out), 10)
                row["kernel_unweighted_ms"] = cs.cuda_ms(lambda: first.launch(csr, None, table, ld, bf16, out), 10)
                if ld % 4 == 0:  # the probe takes vector loads only
                    wq = w if not bf16 else w.to(torch.bfloat16).float()
                    out.index_fill_(0, split, 0.0)
                    first.walk(csr, wq, table, ld, bf16, out, 2)
                    torch.cuda.synchronize()
                    row["probe_2edge_err"] = agree(out, ref, mass)
                    for edges in (1, 2):
                        row[f"walk_{edges}edge_ms"] = cs.cuda_ms(
                            lambda: first.walk(csr, wq, table, ld, bf16, out, edges), 10)
                        row[f"walk_{edges}edge_unweighted_ms"] = cs.cuda_ms(
                            lambda: first.walk(csr, None, table, ld, bf16, out, edges), 10)
                del ref, mass, out, table
                record(**row)
                torch.cuda.empty_cache()


def _turns(old, new, iters):
    """Times of ``old`` and ``new`` taken in turns: old, new, new, old."""
    a = cs.cuda_ms(old, iters)
    b = cs.cuda_ms(new, iters)
    c = cs.cuda_ms(new, iters)
    d = cs.cuda_ms(old, iters)
    return (a, d), (b, c)


def phase_turns(dev, args, first):
    from stgraph_tpu_torch.ops import segment_kernels as SEG
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_plain, spmm_rowmask_traced

    gen = torch.Generator(device=dev).manual_seed(args.seed + 29)
    for order in args.orders:
        graph = ogbn(dev, args, order)
        with torch.inference_mode():
            for label, attr, f, sname, weighted, mode in ogbn_shapes():
                csr = getattr(graph, attr)
                n, e = csr.num_nodes, csr.num_edges
                bf16 = sname == "bf16"
                stream = torch.bfloat16 if bf16 else torch.float32
                x = torch.randn(csr.num_cols, f, device=dev, generator=gen)
                w = torch.rand(csr.capacity, device=dev, generator=gen) if weighted else None
                if mode == "shard":
                    new = lambda: spmm_rowmask_traced(csr, w, x)  # noqa: E731
                else:
                    new = lambda: spmm_rowmask(csr, w, x, stream_dtype=stream)  # noqa: E731
                old = lambda: first.spmm(csr, w, x, bf16)  # noqa: E731
                ref = spmm_rowmask_plain(csr, w, x, stream, cs.PLAIN_EDGE_BLOCK)
                mass = spmm_rowmask_plain(csr, None if w is None else w.abs(), x.abs(), stream, cs.PLAIN_EDGE_BLOCK)
                errs = [agree(cs.poisoned_call((n, f), new)[0], ref, mass), agree(old()[0], ref, mass)]
                del ref, mass
                (o1, o2), (n1, n2) = _turns(old, new, 10)
                lib_a = torch.sparse_csr_tensor(csr.indptr, csr.cols[:e], (w[:e] if weighted else
                                                torch.ones(e, device=dev)), size=(n, csr.num_cols),
                                                check_invariants=False)
                lib = cs.cuda_ms(lambda: torch.sparse.mm(lib_a, x), 5)
                record(phase="turns", order=order, kernel=label, F=f, stream=sname, weighted=weighted,
                       first_ms=[o1, o2], new_ms=[n1, n2], library_ms=lib, err_new=errs[0], err_first=errs[1],
                       bound_ms=cs.k1_bound(n, e, f, weighted)[0])
                torch.cuda.empty_cache()
    h, f = cs.ROWMASK_PPI_TILING
    for name, graph in small_graphs(dev, args).items():
        csr = graph.fwd_csr
        n, e = csr.num_nodes, csr.num_edges
        stream = torch.bfloat16 if name == "ppi" else torch.float32
        x = torch.randn(n, h * f, device=dev, generator=gen)
        w = torch.rand(csr.capacity, h, device=dev, generator=gen)
        new = lambda: spmm_rowmask(csr, w, x, heads=h, with_denom=True, stream_dtype=stream)  # noqa: E731
        old = lambda: first.spmm(csr, w, x, name == "ppi", heads=h, with_denom=True)  # noqa: E731
        ref = spmm_rowmask_plain(csr, w, x, stream, heads=h)
        mass = spmm_rowmask_plain(csr, w, x.abs(), stream, heads=h)
        errs = [agree(cs.poisoned_call((n, h * f), new)[0], ref, mass), agree(old()[0], ref, mass)]
        (o1, o2), (n1, n2) = _turns(old, new, 20)
        record(phase="turns", order=name, kernel="heads", H=h, F=f, stream="bf16" if name == "ppi" else "f32",
               first_ms=[o1, o2], new_ms=[n1, n2], err_new=errs[0], err_first=errs[1],
               library_ms=cs._library_blockdiag_ms(csr, w, x, h, e), bound_ms=cs.rowmask_bound(n, e, h, f)[0])
        vals = torch.randn(csr.capacity, h, device=dev, generator=gen)
        rb = SEG.wide_stream_is_bf16(csr, vals)
        new = lambda: SEG.segment_sum_wide(csr, vals)  # noqa: E731
        old = lambda: first.nogather(csr, vals, rb)  # noqa: E731
        ref = SEG.segment_sum_wide_plain(csr, vals)
        mass = SEG.segment_sum_wide_plain(csr, vals.abs())
        errs = [agree(cs.poisoned_call((n, h), new), ref, mass), agree(old(), ref, mass)]
        (o1, o2), (n1, n2) = _turns(old, new, 20)
        record(phase="turns", order=name, kernel="nogather", K=h, stream="bf16" if rb else "f32",
               first_ms=[o1, o2], new_ms=[n1, n2], err_new=errs[0], err_first=errs[1],
               library_ms=cs._library_segment_sum_ms(csr, vals, e), bound_ms=cs.wide_bound(n, e, h)[0])


def phase_chunks(dev, args):
    from stgraph_tpu_torch.ops import segment_kernels as SEG
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    saved = dict(SK.K1_CHUNK)
    h, f = cs.ROWMASK_PPI_TILING
    try:
        for name, graph in small_graphs(dev, args).items():
            csr = graph.fwd_csr
            stream = torch.bfloat16 if name == "ppi" else torch.float32
            x = torch.randn(csr.num_nodes, h * f, device=dev, generator=gen)
            w = torch.rand(csr.capacity, h, device=dev, generator=gen)
            vals = torch.randn(csr.capacity, h, device=dev, generator=gen)
            for chunk in (128, 256, 512, 1024, 1024, 512, 256, 128):  # up, then down
                SK.K1_CHUNK.update(heads=chunk, nogather=chunk)
                record(phase="chunks", graph=name, chunk=chunk, stream="bf16" if name == "ppi" else "f32",
                       heads_ms=cs.cuda_ms(lambda: SK.spmm_rowmask(csr, w, x, heads=h, with_denom=True,
                                                                   stream_dtype=stream), 100, warmup=5),
                       nogather_ms=cs.cuda_ms(lambda: SEG.segment_sum_wide(csr, vals), 100, warmup=5))
        graph = ogbn(dev, args, args.orders[0])
        csr = graph.fwd_csr
        x128 = torch.randn(csr.num_nodes, 128, device=dev, generator=gen)
        x64 = torch.randn(csr.num_nodes, 64, device=dev, generator=gen)
        w = torch.rand(csr.capacity, device=dev, generator=gen)
        with torch.inference_mode():
            for chunk in (128, 256, 512, 1024):
                SK.K1_CHUNK.update(one_head=chunk)
                record(phase="chunks", graph=f"ogbn {args.orders[0]}", chunk=chunk,
                       one_head_bf16_F128_ms=cs.cuda_ms(
                           lambda: SK.spmm_rowmask(csr, w, x128, stream_dtype=torch.bfloat16), 10),
                       shard_f32_F64_ms=cs.cuda_ms(lambda: SK.spmm_rowmask_traced(csr, None, x64), 10))
    finally:
        SK.K1_CHUNK.update(saved)


def phase_stride(dev, args):
    """K1 alone (C entry, items built, no wrapper) over an f32 table,
    unweighted, one head: F = 47 at its own row stride (188 B rows, the
    aligned-down loads), F = 47 in a table whose stride is padded to 48
    (192 B rows, aligned loads) and F = 64: whether the rows' alignment or
    the walk keeps F = 47 above F = 64."""
    from stgraph_tpu_torch.ops import kernel_lib
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    lib = kernel_lib.load("spmm_rowmask", SK._SIGNATURES)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 37)
    for order in args.orders:
        csr = ogbn(dev, args, order).fwd_csr
        n = csr.num_nodes
        chunk = SK.K1_CHUNK["one_head"]
        item_row, item_beg, split = SK._work_items(csr, chunk)
        x47 = torch.randn(n, 47, device=dev, generator=gen)
        x48 = torch.zeros(n, 48, device=dev)
        x48[:, :47] = x47
        x64 = torch.randn(n, 64, device=dev, generator=gen)

        def run(table, f, ld, out):
            g, tile = SK.k1_lanes(f, 4, ld % 4 == 0 and table.data_ptr() % 16 == 0)
            out.index_fill_(0, split, 0.0)
            rc = lib.stg_spmm_rowmask(csr.indptr.data_ptr(), csr.cols.data_ptr(), None, table.data_ptr(), 0,
                                      item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), out.data_ptr(),
                                      None, f, ld, 1, chunk, g, tile, torch.cuda.current_stream().cuda_stream)
            assert rc == 0, rc

        out47 = torch.empty(n, 47, device=dev)
        out64 = torch.empty(n, 64, device=dev)
        with torch.inference_mode():
            ref = SK.spmm_rowmask_plain(csr, None, x47, torch.float32, cs.PLAIN_EDGE_BLOCK)
            mass = SK.spmm_rowmask_plain(csr, None, x47.abs(), torch.float32, cs.PLAIN_EDGE_BLOCK)
            run(x48, 47, 48, out47)
            torch.cuda.synchronize()
            err48 = agree(out47, ref, mass)
            run(x47, 47, 47, out47)
            torch.cuda.synchronize()
            err47 = agree(out47, ref, mass)
            del ref, mass
            times = {}
            for _ in range(2):  # in turns
                for key, args_ in (("F47_ld47_ms", (x47, 47, 47, out47)), ("F47_ld48_ms", (x48, 47, 48, out47)),
                                   ("F64_ld64_ms", (x64, 64, 64, out64))):
                    times.setdefault(key, []).append(cs.cuda_ms(lambda: run(*args_), 10))
        record(phase="stride", order=order, err_ld47=err47, err_ld48=err48, **times)


def phase_sass(dev, args):
    from stgraph_tpu_torch.ops import kernel_lib

    os.makedirs(args.sass_dir, exist_ok=True)
    src = os.path.join(ROOT, "stgraph_tpu_torch", "csrc", "spmm_rowmask.cu")
    _, log = nvcc_build(src, "spmm_rowmask_sass")
    with open(os.path.join(args.sass_dir, "k1_ptxas.txt"), "w") as fh:
        fh.write(log)
    cuobjdump = os.path.join(os.path.dirname(kernel_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", os.path.join(ROOT, "build", "k1_bench", "spmm_rowmask_sass.so")],
                          capture_output=True, text=True).stdout
    with open(os.path.join(args.sass_dir, "k1_sass.txt"), "w") as fh:
        fh.write(sass)
    spills = [line for line in log.splitlines() if "spill" in line and " 0 bytes spill" not in line]
    record(phase="sass", ptxas_lines=len(log.splitlines()), sass_bytes=len(sass), lines_with_spills=len(spills))


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="check,parts,turns,chunks", help="comma-separated phases")
    ap.add_argument("--baseline-csrc", help="a directory with the first design's spmm_rowmask.cu and "
                                            "segment_sum_wide.cu (parts and turns)")
    ap.add_argument("--orders", default="base,reordered", help="node orders of the ogbn graph")
    ap.add_argument("--scale", type=float, default=1.0, help="synthetic ogbn-products scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the measurements as JSON here")
    ap.add_argument("--sass-dir", default=os.path.join(ROOT, "chiprun_out", "k1_sass"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_bench: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    args.orders = args.orders.split(",")
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
            except cs.SmokeFailure as exc:
                print(f"k1_bench: {name} FAILED: {exc}", flush=True)
                status = 1
            torch.cuda.empty_cache()
            print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"device": smi, "results": RESULTS}, fh, indent=1)
    print(smi)
    return status


if __name__ == "__main__":
    sys.exit(main())
