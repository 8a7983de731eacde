#!/usr/bin/env python3
"""Time K2 (the fused SpMM-SDDMM backward) and K4 (the narrow segment max)
of the PyTorch/CUDA port on one NVIDIA GPU, with their parts apart, on both
node orders of the synthetic ogbn-products graph (the loader's ids, and the
label-propagation order of ``OgbNodeDataLoader(reorder=True)``), at the
main paths' shapes of ``chip_smoke.py``:

- K2, one head, bf16 stream, on the transpose CSR at F = 128 and 47 (a GCN
  training step's three launches: 128, 128, 47);
- K2's heads mode at 32 x 4 on the PPI-sized graph (bf16 stream) and on the
  synthetic Pubmed (f32), the rowmask route's backward;
- K4 in its index form (``max_e el[cols_e, h]``, flash GAT's stability
  max) at K = 8 and 1 on the ogbn graph and on the synthetic Pubmed.

Phases (``--only``):

- ``parts``: the first design's parts, built from ``--baseline-csrc`` (a
  copy of the first design's ``spmm_sddmm_rowmask.cu`` and
  ``segment_max_narrow.cu``): the whole wrapper, the kernel alone, and
  ``k2_k4_parts.cu``'s probes: for K2 the walk alone (gathers and dh's sum,
  no dw), the products alone (no gather) and the dw reduction alone (no
  gather, no product); for K4 the index stream alone (no row gathered) and
  the items alone (no edge read); and the wrapper's parts (the bf16 cast
  and pad, fs to f32, the ``index_fill_`` of split rows, K4's -inf pass).
- ``turns``: the first design and the port's K2 and K4, each through its
  whole wrapper, timed in turns (first, port, port, first) at every shape
  above, each output of the port held against the plain version into a
  NaN-poisoned block (K4 bit for bit), the first design's beside it; the
  bound and the library call (``sparse.mm`` + ``sampled_addmm``;
  ``segment_reduce``) beside them.
- ``chunks``: the port's K2 (one head at F = 128 on the ogbn graph, heads
  at 32 x 4 on PPI and Pubmed) and K4 (K = 8 and 1 on the ogbn graph and
  Pubmed) at work items of 128, 256, 512 and 1024 edges, swept up then
  down.
- ``variants``: the port's K2 and K4 taken apart, each of ``VARIANTS``
  built from an edited copy of its source (a round's steps, K4's edges in
  flight and lanes an item, the launch bound, K2 without dw's products), and each
  ``--variant-dirs`` build from another copy of the sources, timed through
  the wrappers at the main shapes in turns.
- ``sass``: the port's and the first design's K2 and K4 built side by side
  with ``-Xptxas -v``: registers and spills of every instance, written to
  ``--sass-dir``.

    python3 benchmarking/micro/k2_k4_bench.py [--only parts,turns,chunks,variants,sass]
        [--baseline-csrc DIR] [--orders base,reordered] [--variants a,b] [--variant-dirs NAME=DIR]
        [--out PATH] [--sass-dir DIR]

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
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402  (the graphs' scales, bounds, timers and checks of the smoke run)
import k1_bench as kb  # noqa: E402  (the ogbn graphs of both orders, record, turns)
import k8_k9_bench as k89  # noqa: E402  (parallel nvcc builds, ptxas parsing)

_VP, _I = ctypes.c_void_p, ctypes.c_int
FIRST_CHUNK = 1024  # the first design's items
K2_SHAPES = (128, 47)  # one head, bf16: the GCN step's widths
K4_SHAPES = (8, 1)  # the GAT's heads
record = kb.record
# the first design's C entries
FIRST_K2 = [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _VP]
FIRST_K4 = [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _VP, _I, _I, _VP]
PROBE_K2 = [_VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP, _I, _I, _I, _I, _I, _VP]
PROBE_K4 = [_VP, _VP, _VP, _VP, _VP, _I, _VP, _I, _I, _I, _VP]


class First:
    """The first design of K2 and K4, built from ``--baseline-csrc``, called
    as their wrappers called them (1024-edge items, split rows zeroed or
    filled with -inf, a bf16 table with its row stride padded to 8, K4's
    -inf pass), and their probes (``k2_k4_parts.cu``)."""

    def __init__(self, csrc):
        built = k89.nvcc_many({
            "first_k2": (os.path.join(csrc, "spmm_sddmm_rowmask.cu"), []),
            "first_k4": (os.path.join(csrc, "segment_max_narrow.cu"), []),
            "k2_k4_parts": (os.path.join(HERE, "k2_k4_parts.cu"), []),
        })
        self.libs = {}
        for name, (path, _, _) in built.items():
            lib = ctypes.CDLL(path)
            for fn, argtypes in (("stg_spmm_sddmm_rowmask", FIRST_K2), ("stg_segment_max_narrow", FIRST_K4),
                                 ("stg_k2_probe", PROBE_K2), ("stg_k4_probe", PROBE_K4)):
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            self.libs[name] = lib

    @staticmethod
    def items(csr):
        from stgraph_tpu_torch.ops.spmm_kernels import _work_items

        return _work_items(csr, FIRST_CHUNK)

    def k2_inputs(self, csr_t, w_t, g, fs, bf16):
        """The first wrapper's inputs: the gathered table, its stride, f32
        fs and f32 weights."""
        table, ld = kb.First.table(g, bf16)
        return table, ld, fs.to(torch.float32).contiguous(), w_t.reshape(-1).to(torch.float32).contiguous()

    def k2_launch(self, csr_t, wt, table, ld, bf16, fs32, dh, dw, heads, probe=None):
        item_row, item_beg, _ = self.items(csr_t)
        args = (csr_t.indptr.data_ptr(), csr_t.cols.data_ptr(), wt.data_ptr(), table.data_ptr(), int(bf16),
                fs32.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(), item_row.numel(), dh.data_ptr(),
                dw.data_ptr(), dh.shape[1], ld, heads, FIRST_CHUNK)
        if probe is None:
            rc = self.libs["first_k2"].stg_spmm_sddmm_rowmask(*args, torch.cuda.current_stream().cuda_stream)
        else:
            rc = self.libs["k2_k4_parts"].stg_k2_probe(*args, probe, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def k2(self, csr_t, w_t, g, fs, bf16, heads=1):
        """The whole first wrapper: table, outputs, zeroed padding and split
        rows, kernel."""
        table, ld, fs32, wt = self.k2_inputs(csr_t, w_t, g, fs, bf16)
        n, f = csr_t.num_nodes, g.shape[1]
        dh = torch.empty(n, f, device=g.device)
        dw = torch.empty(csr_t.capacity, heads, device=g.device)
        dw[csr_t.num_edges:] = 0.0
        split = self.items(csr_t)[2]
        if split.numel():
            dh.index_fill_(0, split, 0.0)
        self.k2_launch(csr_t, wt, table, ld, bf16, fs32, dh, dw, heads)
        return dh, (dw.reshape(-1) if heads == 1 else dw)

    def k4_launch(self, csr, index, table, out, probe=None):
        item_row, item_beg, split = self.items(csr)
        k = table.shape[1]
        idx = None if index is None else index.data_ptr()
        if probe is None:
            rc = self.libs["first_k4"].stg_segment_max_narrow(
                csr.indptr.data_ptr(), idx, table.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(),
                item_row.numel(), split.data_ptr(), split.numel(), out.data_ptr(), k, FIRST_CHUNK,
                torch.cuda.current_stream().cuda_stream)
        else:
            rc = self.libs["k2_k4_parts"].stg_k4_probe(
                csr.indptr.data_ptr(), idx, table.data_ptr(), item_row.data_ptr(), item_beg.data_ptr(),
                item_row.numel(), out.data_ptr(), k, FIRST_CHUNK, probe, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc

    def k4(self, csr, vals, index):
        table = vals.to(torch.float32).contiguous()
        out = torch.empty(csr.num_nodes, table.shape[1], device=vals.device)
        split = self.items(csr)[2]
        if split.numel():
            out.index_fill_(0, split, float("-inf"))
        self.k4_launch(csr, index, table, out)
        return out


_SMALL = {}


def small_graphs(dev, args):
    """The PPI-sized graph (bf16 stream) and the synthetic Pubmed (f32)."""
    from stgraph_tpu_torch.dataset import PubmedDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph

    if not _SMALL:
        _SMALL["ppi"] = cs.ppi_graph(dev, args.seed)[0]
        STGraphDataset._offline = True
        pubmed = PubmedDataLoader(cache_dir=os.path.join(args.data_dir, "datasets"))
        _SMALL["pubmed"] = StaticGraph(pubmed.get_edges(), None, pubmed.gdata["num_nodes"], device=dev)
    return _SMALL


def k2_check(dh, dw, csr_t, w_t, g, fs, stream, heads, block):
    """Worst err / sum|terms| of dh and dw against the plain version, and
    whether every padding slot of dw is 0."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd_plain

    refs = spmm_rowmask_bwd_plain(csr_t, w_t, g, fs, stream, block, heads=heads)
    masses = spmm_rowmask_bwd_plain(csr_t, w_t.abs(), g.abs(), fs.abs(), stream, block, heads=heads)
    stats = cs._stats([dh, dw], list(refs), list(masses))
    del refs, masses
    pad = not dw[csr_t.num_edges:].any().item()
    return max(stats[0][1], stats[1][1]), pad


def k2_cases(dev, args, gen, orders):
    """(label, order, csr_t, w_t, g, fs, heads, F, bf16) of every K2 shape."""
    for order in orders:
        csr_t = kb.ogbn(dev, args, order).bwd_csr
        n = csr_t.num_nodes
        w_t = torch.rand(csr_t.capacity, device=dev, generator=gen)
        for f in K2_SHAPES:
            g = torch.randn(csr_t.num_cols, f, device=dev, generator=gen)
            fs = torch.randn(n, f, device=dev, generator=gen)
            yield "one head", order, csr_t, w_t, g, fs, 1, f, True
            del g, fs
            torch.cuda.empty_cache()
    h, f = cs.ROWMASK_PPI_TILING
    for name, graph in small_graphs(dev, args).items():
        csr_t = graph.bwd_csr
        n = csr_t.num_nodes
        w_t = torch.rand(csr_t.capacity, h, device=dev, generator=gen)
        g, fs = (torch.randn(n, h * f, device=dev, generator=gen) for _ in range(2))
        yield "heads", name, csr_t, w_t, g, fs, h, f, name == "ppi"


def k4_cases(dev, args, gen, orders):
    """(order, csr, el, K) of every K4 shape."""
    for order in orders:
        csr = kb.ogbn(dev, args, order).fwd_csr
        for k in K4_SHAPES:
            yield order, csr, torch.randn(csr.num_nodes, k, device=dev, generator=gen), k
    for k in K4_SHAPES:
        csr = small_graphs(dev, args)["pubmed"].fwd_csr
        yield "pubmed", csr, torch.randn(csr.num_nodes, k, device=dev, generator=gen), k


def phase_parts(dev, args, first):
    gen = torch.Generator(device=dev).manual_seed(args.seed + 59)
    with torch.inference_mode():
        for label, order, csr_t, w_t, g, fs, h, f, bf16 in k2_cases(dev, args, gen, args.orders):
            hf = g.shape[1]
            stream = torch.bfloat16 if bf16 else torch.float32
            row = dict(phase="parts", kernel=f"K2 {label}", order=order, H=h, F=f, stream="bf16" if bf16 else "f32",
                       N=csr_t.num_nodes, E=csr_t.num_edges)
            table, ld, fs32, wt = first.k2_inputs(csr_t, w_t, g, fs, bf16)
            row["cast_pad_ms"] = cs.cuda_ms(lambda: kb.First.table(g, bf16), 10) if bf16 else 0.0
            row["fs_f32_ms"] = cs.cuda_ms(lambda: fs.to(torch.float32).contiguous(), 10)
            split = first.items(csr_t)[2]
            dh = torch.empty(csr_t.num_nodes, hf, device=dev)
            dw = torch.empty(csr_t.capacity, h, device=dev)
            row["split_rows"] = split.numel()
            row["index_fill_ms"] = cs.cuda_ms(lambda: dh.index_fill_(0, split, 0.0), 10)
            res = first.k2(csr_t, w_t, g, fs, bf16, h)
            torch.cuda.synchronize()
            row["err"], row["pad_zero"] = k2_check(*res, csr_t, w_t, g, fs, stream, h, cs.K2_PLAIN_EDGE_BLOCK)
            del res
            dh.zero_()
            dw.zero_()
            first.k2_launch(csr_t, wt, table, ld, bf16, fs32, dh, dw, h, probe=0)
            torch.cuda.synchronize()
            row["probe_err"] = k2_check(dh, dw.reshape(-1) if h == 1 else dw, csr_t, w_t, g, fs, stream, h,
                                        cs.K2_PLAIN_EDGE_BLOCK)[0]
            timings = {
                "wrapper_ms": lambda: first.k2(csr_t, w_t, g, fs, bf16, h),
                "kernel_ms": lambda: first.k2_launch(csr_t, wt, table, ld, bf16, fs32, dh, dw, h),
                "probe_whole_ms": lambda: first.k2_launch(csr_t, wt, table, ld, bf16, fs32, dh, dw, h, probe=0),
                "walk_ms": lambda: first.k2_launch(csr_t, wt, table, ld, bf16, fs32, dh, dw, h, probe=1),
                "products_ms": lambda: first.k2_launch(csr_t, wt, table, ld, bf16, fs32, dh, dw, h, probe=2),
                "dw_reduction_ms": lambda: first.k2_launch(csr_t, wt, table, ld, bf16, fs32, dh, dw, h, probe=3),
            }
            iters = 10 if label == "one head" else 50
            for key, fn in timings.items():
                row[key] = cs.cuda_ms(fn, iters, warmup=2)
            row["bound_ms"] = (cs.k2_bound(csr_t.num_nodes, csr_t.num_edges, f)[0] if h == 1 else
                               cs.rowmask_bwd_bound(csr_t.num_nodes, csr_t.num_edges, h, f)[0])
            row["gathered_GB"] = csr_t.num_edges * ld * (2 if bf16 else 4) / 1e9
            record(**row)
            del table, fs32, wt, dh, dw
            torch.cuda.empty_cache()
        for order, csr, el, k in k4_cases(dev, args, gen, args.orders):
            row = dict(phase="parts", kernel="K4", order=order, K=k, N=csr.num_nodes, E=csr.num_edges)
            out = torch.empty(csr.num_nodes, k, device=dev)
            split = first.items(csr)[2]
            row["split_rows"] = split.numel()
            row["index_fill_ms"] = cs.cuda_ms(lambda: out.index_fill_(0, split, float("-inf")), 10)
            got = first.k4(csr, el, csr.cols)
            torch.cuda.synchronize()
            row["bit_equal"] = bool(torch.equal(got, cs_plain_k4(csr, el)))
            timings = {
                "wrapper_ms": lambda: first.k4(csr, el, csr.cols),
                "kernel_ms": lambda: first.k4_launch(csr, csr.cols, el, out),
                "probe_whole_ms": lambda: first.k4_launch(csr, csr.cols, el, out, probe=0),
                "index_stream_ms": lambda: first.k4_launch(csr, csr.cols, el, out, probe=1),
                "items_ms": lambda: first.k4_launch(csr, csr.cols, el, out, probe=2),
            }
            iters = 20 if order != "pubmed" else 100
            for key, fn in timings.items():
                row[key] = cs.cuda_ms(fn, iters, warmup=2)
            row["bound_ms"] = cs.k4_bound(csr.num_nodes, csr.num_edges, k)[0]
            record(**row)
            del out, got
            torch.cuda.empty_cache()


def cs_plain_k4(csr, el):
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow_plain

    return segment_max_narrow_plain(csr, el, index=csr.cols, edge_block=1 << 24)


def _library_k2_ms(csr_t, w_t, g, fs, h):
    e = csr_t.num_edges
    if h > 1:
        return cs._library_multihead_bwd_ms(csr_t, w_t, g, fs, h, e)
    try:
        a = torch.sparse_csr_tensor(csr_t.indptr, csr_t.cols[:e], w_t[:e], size=(csr_t.num_nodes, csr_t.num_cols),
                                    check_invariants=False)
        return (cs.cuda_ms(lambda: torch.sparse.mm(a, g), 3)
                + cs.cuda_ms(lambda: torch.sparse.sampled_addmm(a, fs, g.t(), beta=0.0), 3))
    except RuntimeError as exc:
        print(f"library yardstick unavailable: {exc}")
        return None


def phase_turns(dev, args, first):
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd

    gen = torch.Generator(device=dev).manual_seed(args.seed + 61)
    with torch.inference_mode():
        for label, order, csr_t, w_t, g, fs, h, f, bf16 in k2_cases(dev, args, gen, args.orders):
            stream = torch.bfloat16 if bf16 else torch.float32
            n, e = csr_t.num_nodes, csr_t.num_edges
            new = lambda: spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=stream, heads=h)  # noqa: E731
            old = lambda: first.k2(csr_t, w_t, g, fs, bf16, h)  # noqa: E731
            new()  # the items, built once
            dh, dw = cs.poisoned_k2_call((n, g.shape[1]), (csr_t.capacity, h), new)
            err_new, pad_new = k2_check(dh, dw, csr_t, w_t, g, fs, stream, h, cs.K2_PLAIN_EDGE_BLOCK)
            del dh, dw
            err_first, _ = k2_check(*old(), csr_t, w_t, g, fs, stream, h, cs.K2_PLAIN_EDGE_BLOCK)
            cs.check(err_new <= cs.KERNEL_TOL and pad_new,
                     f"K2 {label} {h} x {f} on {order} disagrees with its plain version: {err_new}, pad {pad_new}")
            iters = 10 if label == "one head" else 50
            (o1, o2), (n1, n2) = kb._turns(old, new, iters)
            bound = cs.k2_bound(n, e, f) if h == 1 else cs.rowmask_bwd_bound(n, e, h, f)
            record(phase="turns", kernel=f"K2 {label}", order=order, H=h, F=f, stream="bf16" if bf16 else "f32",
                   N=n, E=e, first_ms=[o1, o2], new_ms=[n1, n2], err_new=err_new, err_first=err_first,
                   bound_ms=bound[0], bound_by=bound[1], library_ms=_library_k2_ms(csr_t, w_t, g, fs, h))
            torch.cuda.empty_cache()
        for order, csr, el, k in k4_cases(dev, args, gen, args.orders):
            n, e = csr.num_nodes, csr.num_edges
            new = lambda: segment_max_narrow(csr, el, index=csr.cols)  # noqa: E731
            old = lambda: first.k4(csr, el, csr.cols)  # noqa: E731
            new()
            ref = cs_plain_k4(csr, el)
            got = cs.poisoned_call((n, k), new)
            torch.cuda.synchronize()
            equal_new, equal_first = bool(torch.equal(got, ref)), bool(torch.equal(old(), ref))
            cs.check(equal_new, f"K4 at K={k} on {order} differs from its plain version")
            del got, ref
            iters = 20 if order != "pubmed" else 100
            (o1, o2), (n1, n2) = kb._turns(old, new, iters)
            bound = cs.k4_bound(n, e, k)
            record(phase="turns", kernel="K4", order=order, K=k, N=n, E=e, first_ms=[o1, o2], new_ms=[n1, n2],
                   bit_equal_new=equal_new, bit_equal_first=equal_first, bound_ms=bound[0], bound_by=bound[1],
                   library_ms=cs._library_k4_ms(csr, el, e))
            torch.cuda.empty_cache()


def phase_chunks(dev, args):
    from stgraph_tpu_torch.ops import segment_kernels as SEG
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    gen = torch.Generator(device=dev).manual_seed(args.seed + 67)
    saved2, saved4 = dict(SK.K2_CHUNK), SEG.K4_CHUNK
    sweep = (128, 256, 512, 1024, 1024, 512, 256, 128)  # up, then down
    try:
        with torch.inference_mode():
            for label, order, csr_t, w_t, g, fs, h, f, bf16 in k2_cases(dev, args, gen, args.orders[:1]):
                if label == "one head" and f != 128:
                    continue
                stream = torch.bfloat16 if bf16 else torch.float32
                mode = "heads" if h > 1 else "one_head"
                for chunk in sweep:
                    SK.K2_CHUNK[mode] = chunk
                    record(phase="chunks", kernel=f"K2 {label}", order=order, H=h, F=f, chunk=chunk,
                           ms=cs.cuda_ms(lambda: SK.spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=stream,
                                                                     heads=h), 10 if h == 1 else 100, warmup=2))
                SK.K2_CHUNK.update(saved2)
            for order, csr, el, k in k4_cases(dev, args, gen, args.orders[:1]):
                iters = 20 if order != "pubmed" else 100
                for chunk in sweep:
                    SEG.K4_CHUNK = chunk
                    record(phase="chunks", kernel="K4", order=order, K=k, chunk=chunk,
                           ms=cs.cuda_ms(lambda: SEG.segment_max_narrow(csr, el, index=csr.cols), iters, warmup=2))
                SEG.K4_CHUNK = saved4
    finally:
        SK.K2_CHUNK.update(saved2)
        SEG.K4_CHUNK = saved4


K2_SRC, K4_SRC = "spmm_sddmm_rowmask.cu", "segment_max_narrow.cu"
K2_STEPS = "constexpr int kSteps = kEps * 4 <= 32 ? 4 : 32 / kEps;"
K4_U = "constexpr int kU = K <= 2 ? 8 : (K <= 8 ? 4 : 2);"
K4_L = "constexpr int kL = 16;  // lanes a work item"
# The port's designs taken apart: (file, text, replacement) edits of a copy
# of csrc/ (none: the sources as they stand)
VARIANTS = {
    "source": (),
    "k2_steps_2": ((K2_SRC, K2_STEPS, "constexpr int kSteps = kEps * 2 <= 32 ? 2 : 32 / kEps;"),),
    "k2_steps_8": ((K2_SRC, K2_STEPS, "constexpr int kSteps = kEps * 8 <= 32 ? 8 : 32 / kEps;"),),
    "k2_no_dw_products": ((K2_SRC, "const uint32_t r = mul_bf16x2(xq[m], qa[m]);", "const uint32_t r = 0u;"),),
    "k2_two_blocks": ((K2_SRC, "__global__ void __launch_bounds__(kWarpsPerBlock * 32)\nspmm_sddmm_rowmask_kernel",
                       "__global__ void __launch_bounds__(kWarpsPerBlock * 32, 2)\nspmm_sddmm_rowmask_kernel"),),
    "k4_u_half": ((K4_SRC, K4_U, "constexpr int kU = K <= 2 ? 4 : (K <= 8 ? 2 : 1);"),),
    "k4_u_x2": ((K4_SRC, K4_U, "constexpr int kU = K <= 2 ? 16 : (K <= 8 ? 8 : 4);"),),
    "k4_lanes_8": ((K4_SRC, K4_L, "constexpr int kL = 8;"),),
    "k4_lanes_32": ((K4_SRC, K4_L, "constexpr int kL = 32;"),),
}


def phase_variants(dev, args):
    """The port's K2 and K4 taken apart: each of ``VARIANTS`` built from an
    edited copy of its source (a round's steps, K4's edges in flight, the
    launch bound, K2 without dw's products), then the wrappers at the main
    shapes on the loader's order with each build, in turns (each build, then
    again in reverse). Only "source" is the port's; a variant without a part
    times the rest."""
    from stgraph_tpu_torch.ops import kernel_lib
    from stgraph_tpu_torch.ops import segment_kernels as SEG
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    csrc = os.path.join(ROOT, "stgraph_tpu_torch", "csrc")
    names = [n for n in args.variants.split(",") if n]
    dirs = dict(item.split("=", 1) for item in args.variant_dirs.split(",") if item)
    jobs = {}
    for name in names + list(dirs):
        d = os.path.join(k89.BUILD_DIR, f"k2k4_variant_{name}")
        os.makedirs(d, exist_ok=True)
        for fn in (K2_SRC, K4_SRC):
            src_dir = dirs[name] if name in dirs and os.path.exists(os.path.join(dirs[name], fn)) else csrc
            with open(os.path.join(src_dir, fn)) as fh:
                text = fh.read()
            for f_, old, new in VARIANTS.get(name, ()):
                if f_ == fn:
                    assert old in text, (name, old)
                    text = text.replace(old, new)
            with open(os.path.join(d, fn), "w") as fh:
                fh.write(text)
            jobs[f"{name}:{fn}"] = (os.path.join(d, fn), [])
    built = k89.nvcc_many(jobs)
    libs = {}
    for job, (path, log, _) in built.items():
        inst = k89.ptxas_instances(log)
        record(phase="variants", library=job, registers=[min((i[1] for i in inst), default=0),
                                                         max((i[1] for i in inst), default=0)],
               with_spills=sum(1 for i in inst if i[2]))
        lib = ctypes.CDLL(path)
        for fn, sig in list(SK._K2_SIGNATURES.items()) + list(SEG._SIGNATURES.items()):
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = sig
                getattr(lib, fn).restype = ctypes.c_int
        libs[job] = lib
    saved = {k: kernel_lib._loaded.get(k) for k in ("spmm_sddmm_rowmask", "segment_max_narrow")}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 71)
    try:
        with torch.inference_mode():
            calls = {}
            graph = kb.ogbn(dev, args, args.orders[0])
            csr, csr_t = graph.fwd_csr, graph.bwd_csr
            w_t = torch.rand(csr_t.capacity, device=dev, generator=gen)
            tabs = {f: (torch.randn(csr_t.num_cols, f, device=dev, generator=gen),
                        torch.randn(csr_t.num_nodes, f, device=dev, generator=gen)) for f in K2_SHAPES}
            for f, (g, fs) in tabs.items():
                calls[f"k2_F{f}"] = (lambda g=g, fs=fs: SK.spmm_rowmask_bwd(csr_t, w_t, g, fs,
                                                                           stream_dtype=torch.bfloat16), 10)
            for k in K4_SHAPES:
                el = torch.randn(csr.num_nodes, k, device=dev, generator=gen)
                calls[f"k4_K{k}"] = (lambda el=el: SEG.segment_max_narrow(csr, el, index=csr.cols), 20)
            h, f = cs.ROWMASK_PPI_TILING
            ppi_t = small_graphs(dev, args)["ppi"].bwd_csr
            wh = torch.rand(ppi_t.capacity, h, device=dev, generator=gen)
            gh, fh = (torch.randn(ppi_t.num_nodes, h * f, device=dev, generator=gen) for _ in range(2))
            calls["k2_heads_ppi"] = (lambda: SK.spmm_rowmask_bwd(ppi_t, wh, gh, fh, stream_dtype=torch.bfloat16,
                                                                 heads=h), 100)
            times = {}
            names = names + list(dirs)
            for name in names + names[::-1]:
                kernel_lib._loaded["spmm_sddmm_rowmask"] = libs[f"{name}:{K2_SRC}"]
                kernel_lib._loaded["segment_max_narrow"] = libs[f"{name}:{K4_SRC}"]
                for key, (fn, iters) in calls.items():
                    times.setdefault(f"{key}:{name}", []).append(round(cs.cuda_ms(fn, iters, warmup=2), 4))
            record(phase="variants", order=args.orders[0], **times)
    finally:
        for k, v in saved.items():
            if v is None:
                kernel_lib._loaded.pop(k, None)
            else:
                kernel_lib._loaded[k] = v


def phase_sass(dev, args):
    os.makedirs(args.sass_dir, exist_ok=True)
    designs = {"port": os.path.join(ROOT, "stgraph_tpu_torch", "csrc")}
    if args.baseline_csrc:
        designs["first"] = args.baseline_csrc
    jobs = {f"{design}_{lib}": (os.path.join(d, f"{lib}.cu"), [])
            for design, d in designs.items() for lib in ("spmm_sddmm_rowmask", "segment_max_narrow")}
    built = k89.nvcc_many(jobs)
    for name, (path, log, secs) in built.items():
        inst = k89.ptxas_instances(log)
        names = k89.demangle([i[0] for i in inst])
        with open(os.path.join(args.sass_dir, f"{name}_instances.txt"), "w") as fh:
            for (_, regs, spill), nm in zip(inst, names):
                fh.write(f"{regs:4d} registers {spill:4d} B spilled  {nm}\n")
        record(phase="sass", library=name, nvcc_s=secs, instances=len(inst),
               registers=[min((i[1] for i in inst), default=0), max((i[1] for i in inst), default=0)],
               with_spills=sum(1 for i in inst if i[2]), max_spill_B=max((i[2] for i in inst), default=0),
               spilling=[f"{nm} {sp} B" for (_, _, sp), nm in zip(inst, names) if sp])


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default="parts,turns,chunks,sass", help="comma-separated phases")
    ap.add_argument("--baseline-csrc", help="a directory with the first design's spmm_sddmm_rowmask.cu and "
                                            "segment_max_narrow.cu (parts, turns, sass)")
    ap.add_argument("--orders", default="base,reordered", help="node orders of the ogbn graph")
    ap.add_argument("--variants", default=",".join(VARIANTS), help="comma-separated builds of the variants phase")
    ap.add_argument("--variant-dirs", default="", help="NAME=DIR,...: more builds of the variants phase, each "
                                                        "from DIR's copy of the K2 and K4 sources (others from csrc)")
    ap.add_argument("--scale", type=float, default=1.0, help="synthetic ogbn-products scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the measurements as JSON here")
    ap.add_argument("--sass-dir", default=os.path.join(ROOT, "chiprun_out", "k2_k4_sass"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k2_k4_bench: needs an NVIDIA GPU", file=sys.stderr)
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
                print(f"k2_k4_bench: {name} FAILED:\n{traceback.format_exc()}", flush=True)
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
