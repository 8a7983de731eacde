"""K8 and K9: flash-GAT, the fused segment-softmax attention, forward and
backward, each with its wrapper and its plain PyTorch version, and the
``autograd.Function`` that joins them.

Counterpart of ``stgraph_tpu/ops/flash_gat.py``. For a CSR (rows =
destinations d, cols = sources), per-head scores ``el``, ``er`` (N, H) and
flat source features ``fs`` (N, H*F):

    m[d]   = leaky(max_{e in row d} el[src_e] + er[d])     (K4; exact, since
             leaky is monotone: the JAX module's docstring, :8-14)
    w_e    = exp(min(leaky(el[src_e] + er[d]) - m[d], 0))
    out[d] = sum_e w_e fs[src_e] / max(sum_e w_e, tiny)     (K8, per head)

The backward (:880-947) is a single edge pass on the transpose CSR (K9)
plus node-level glue in plain torch: ``gu = g / den``,
``c = sum_f g * out / den``, and ``der = <gu, u> - c * p`` from K8's aux
outputs ``u = sum_e w lp fs[src]`` and ``p = sum_e w lp`` (``lp`` the
leaky slope at the edge's pre-activation score). The forward computes the
aux outputs only when a gradient is needed, so serving under
``torch.inference_mode()`` never pays for them.

The CUDA kernels live in ``csrc/flash_gat_fwd.cu`` (K8, replacing
``_flash_fwd_kernel``, ``:191``) and ``csrc/flash_gat_bwd.cu`` (K9,
replacing ``_flash_bwd_b_kernel``, ``:365``); both reach ``pallas_call`` at
``:663``. They are bound by memory: the gathered feature rows, as for K1.
Their design is described in the sources. The TPU kernels' hi/lo bf16 lane
pairs, one-hot matmuls and 128-lane side tile are layout, not contract:
the port reads ``el``, ``er``, ``m`` and ``c`` in f32.

Numerics (the JAX kernels in interpret mode, and the plain versions here):
with an f32 stream everything is f32; with a bf16 stream (graphs of at
least ``spmm_cuda._BF16_STREAM_MIN_EDGES`` edge slots) ``fs`` or ``gu``
and the weight are rounded to bf16 and so is their product, while sums,
``den``, ``el``, ``er``, ``m`` and ``c`` stay f32.

Attention dropout (``attn_drop`` > 0, the JAX kernels' ``dropped``
mode): the keep factor ``q`` of each (edge, head) is ``edge_keep_mask``'s
stateless hash of (src, dst, head, seed), 0 or 1/(1-p). The numerator
takes ``w q`` and ``u`` takes ``w lp q``, while ``den`` and ``p`` keep the
undropped weights (dropout acts on the normalised coefficients); K9 takes
``w q`` for ``dfs`` and ``ds0 = w (dw q - c) lp``. The JAX package builds
the mask outside its kernels as an (H, E) f32 plane per pass, one for each
edge order (``:764-788``); K8 and K9 hash it in registers from the
(src, dst) pair they already hold (``csrc/edge_keep_mask.cuh``), and the
hash does not depend on the edge's position, so the transpose-order
backward draws the forward's mask. The seed is a one-element int64 tensor
on the data's device (its low 32 bits), read by the kernels there: no host
sync.

Each wrapper takes its plain version only because the tensors it was given
lie on the CPU. For a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import kernel_lib
from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow
from stgraph_tpu_torch.ops.spmm_kernels import (
    ROW_CHUNK,
    _gathered_table,
    _stream_is_bf16,
    _work_items,
)

__all__ = [
    "FLASH_MAX_HEADS",
    "FLASH_MAX_WIDTH",
    "edge_keep_mask",
    "edge_keep_mask_kernel",
    "flash_gat_attention",
    "flash_gat_bwd",
    "flash_gat_bwd_plain",
    "flash_gat_fwd",
    "flash_gat_fwd_plain",
    "flash_supported",
    "reference_flash_tiling",
    "stability_max",
]

# The Hopper kernels' tiling: one warp per row holds every head's weights
# for 32 edges (H <= 16) and every column of the row (H * F <= 256, 8 a
# lane).
FLASH_MAX_HEADS = 16
FLASH_MAX_WIDTH = 256

_TINY = torch.finfo(torch.float32).tiny

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FWD_SIGNATURES = {
    "stg_flash_gat_fwd": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _I, _VP, _I,
                          _VP, _VP, _VP, _VP, _I, _I, _I, _F, _I, _VP, _F, _F, _VP],
    "stg_edge_keep_mask": [_VP, _VP, ctypes.c_longlong, _I, _VP, _F, _F, _VP, _VP],
}
_BWD_SIGNATURES = {
    "stg_flash_gat_bwd": [_VP, _VP, _VP, _VP, _VP, _I, _VP, _VP, _VP, _I, _VP, _VP,
                          _I, _I, _I, _F, _I, _VP, _F, _F, _VP],
}


def flash_supported(heads: int, f: int) -> bool:
    """Whether K8 and K9 take this tiling: ``1 <= heads <= 16`` and
    ``1 <= heads * f <= 256``. Unlike the TPU kernels (``flash_gat.py:99``)
    there is no 128-lane rule: any ``f`` up to the width bound works."""
    return 1 <= heads <= FLASH_MAX_HEADS and f >= 1 and heads * f <= FLASH_MAX_WIDTH


# The TPU kernels' side tile: 128 lanes, which must hold six H-wide fields.
_REFERENCE_SIDE = 128


def reference_flash_tiling(heads: int, f: int) -> bool:
    """The JAX package's ``flash_supported`` (``stgraph_tpu/ops/flash_gat.py:99-106``),
    copied: the tilings its TPU sends to the flash kernels. One head takes
    ``f % 128 == 0`` or ``f <= 128``; several need ``128 % f == 0``,
    ``(heads * f) % 128 == 0`` and ``6 * heads <= 128``. At these tilings
    the reference trains with attention dropout inside its flash kernels,
    on ``edge_keep_mask``'s hash, and ``GATConv`` keeps that mask (on K8's
    and K9's dropout mode, or on the edge-domain route past the port's
    ``flash_supported``); off them both packages draw the mask at random on
    their edge-domain routes."""
    if heads < 1 or f < 1:
        return False
    if heads == 1:
        return f % 128 == 0 or f <= 128
    return 128 % f == 0 and (heads * f) % 128 == 0 and 6 * heads <= _REFERENCE_SIDE


def _leaky(s0: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(s0 >= 0, s0, slope * s0)


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``, in halves so that no int64 product overflows."""
    return (((((x >> 16) * c) & _M32) << 16) + (x & 0xFFFF) * c) & _M32


def _seed_tensor(seed, device: torch.device) -> torch.Tensor:
    """The seed as the kernels read it: one int64 on ``device``, its low 32
    bits the hash's seed (a Python int or a tensor of any integer type)."""
    t = seed.to(device=device, dtype=torch.int64) if torch.is_tensor(seed) else torch.tensor(
        int(seed), dtype=torch.int64, device=device)
    return (t.reshape(1) & _M32).contiguous()


def _check_rate(rate: float) -> float:
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must lie in [0, 1), got {rate}")
    return rate


def _keep_scale(rate: float) -> float:
    """``f32(1 / (1 - rate))``, rounded as the JAX function rounds it."""
    return float(np.float32(1.0 / (1.0 - rate)))


def edge_keep_mask(src: torch.Tensor, dst: torch.Tensor, seed, heads: int, rate: float) -> torch.Tensor:
    """(E, heads) f32 attention-dropout keep mask from the stateless
    (src, dst, head, seed) hash: 0, or ``f32(1 / (1 - rate))``.

    JAX ``flash_gat.edge_keep_mask`` (``stgraph_tpu/ops/flash_gat.py:109-139``)
    bit for bit: its uint32 arithmetic in int64, every product and sum taken
    mod 2^32; ``u = (x >> 8) * 2^-24`` (exact in f32) compared with the f32
    rounding of ``rate``. The mask depends on the (src, dst) pairs, not on
    their order. ``seed`` is a Python int or a one-element integer tensor
    (its low 32 bits; on ``src``'s device, for no host sync). The same hash
    runs inside K8 and K9 (``csrc/edge_keep_mask.cuh``).
    """
    rate = _check_rate(rate)
    dev = src.device
    s = src.to(torch.int64) & _M32
    d = dst.to(torch.int64) & _M32
    k = _mul32(s, 0x9E3779B9) ^ _mul32(d, 0x85EBCA6B) ^ ((_seed_tensor(seed, dev) + 0x27D4EB2F) & _M32)
    hs = _mul32(torch.arange(heads, dtype=torch.int64, device=dev), 0x165667B1)
    x = (k[:, None] + hs[None, :]) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    u = (x >> 8).to(torch.float32) * 2.0**-24
    keep = u >= torch.tensor(rate, dtype=torch.float32, device=dev)
    scale = torch.tensor(_keep_scale(rate), dtype=torch.float32, device=dev)
    return torch.where(keep, scale, torch.zeros((), dtype=torch.float32, device=dev))


def edge_keep_mask_kernel(src: torch.Tensor, dst: torch.Tensor, seed, heads: int, rate: float) -> torch.Tensor:
    """``edge_keep_mask`` from the device function K8 and K9 hash with
    (``stg_edge_keep_mask`` in ``csrc/flash_gat_fwd.cu``), so that a check
    can hold the in-kernel hash against the port's bit for bit. ``src`` and
    ``dst`` are (E,) int32. Not on any model's path; the plain version on
    the CPU."""
    if src.shape != dst.shape or src.dim() != 1:
        raise ValueError("src and dst must be (E,) and of one shape")
    if src.device.type == "cpu":
        return edge_keep_mask(src, dst, seed, heads, rate)
    rate = _check_rate(rate)
    lib = kernel_lib.load("flash_gat_fwd_dropout", _FWD_SIGNATURES)  # the library that hashes
    dev = src.device
    s32, d32 = (t.to(device=dev, dtype=torch.int32).contiguous() for t in (src, dst))
    seed_t = _seed_tensor(seed, dev)
    out = torch.empty(src.shape[0], heads, dtype=torch.float32, device=dev)
    rc = lib.stg_edge_keep_mask(s32.data_ptr(), d32.data_ptr(), src.shape[0], heads, seed_t.data_ptr(), rate,
                                _keep_scale(rate), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"stg_edge_keep_mask launch failed with cudaError {rc}")
    edge_keep_mask_kernel.launches += 1
    return out


edge_keep_mask_kernel.launches = 0  # kernel launches since the count was last reset


def stability_max(csr: CSR, el: torch.Tensor, er: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """``m = leaky(K4(el[cols]) + er)``, (N, H): the softmax's per-row
    maximum, by K4 over ``el`` read at ``cols`` (no (E, H) plane)."""
    elmax = segment_max_narrow(csr, el, index=csr.cols)
    return _leaky(elmax + er, float(negative_slope))


def _row_blocks(indptr: np.ndarray, edge_block: Optional[int]):
    """Row ranges ``(r0, r1, e0, e1)`` of about ``edge_block`` edges each."""
    n = indptr.shape[0] - 1
    e = int(indptr[-1])
    block = max(e, 1) if edge_block is None else edge_block
    firsts = np.searchsorted(indptr, np.arange(0, e, block), side="right") - 1
    starts = np.unique(np.concatenate([[0], firsts]))
    bounds = list(starts[starts < n]) + [n]
    return [(r0, r1, int(indptr[r0]), int(indptr[r1])) for r0, r1 in zip(bounds[:-1], bounds[1:])]


def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf16 else x


def _sum_rows(n_rows: int, rows: torch.Tensor, terms: torch.Tensor) -> torch.Tensor:
    out = torch.zeros((n_rows,) + tuple(terms.shape[1:]), dtype=torch.float64, device=terms.device)
    return out.index_add_(0, rows, terms.double()).float()


def flash_gat_fwd_plain(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    m: torch.Tensor,
    fs: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
    stream_dtype=None,
    aux: bool = False,
    edge_block: Optional[int] = None,
    rate: float = 0.0,
    seed=None,
):
    """K8's plain version: ``(out, den, u, p)`` (``u``, ``p`` None without
    ``aux``), all f32.

    Rounds where the kernel and the JAX kernel round (bf16 stream: ``fs``
    and the weight, ``w`` or ``w * lp``, and their product) and sums in
    f64, rounded once to f32. ``edge_block`` bounds the (edges, H*F)
    temporaries, as for ``spmm_rowmask_plain``. With ``rate`` > 0 (the
    dropout mode, ``seed`` as for ``edge_keep_mask``) the numerator takes
    ``round(w * q)`` and ``u`` takes ``round(w * lp * q)``, ``q`` the keep
    mask of (cols, rows), while ``den`` and ``p`` sum the undropped ``w``
    and ``w * lp``: JAX's order of operations (``flash_gat.py:294-333``).
    """
    n, hf = fs.shape
    h = heads
    f = hf // h
    slope = float(negative_slope)
    bf16 = _stream_is_bf16(fs, stream_dtype)
    dt = torch.bfloat16 if bf16 else torch.float32
    rate = _check_rate(rate)
    parts = {"acc": [], "den": [], "u": [], "p": []}
    for r0, r1, e0, e1 in _row_blocks(csr.host_arrays()[0], edge_block):
        src = csr.cols[e0:e1].long()
        dst = csr.rows[e0:e1].long()
        local = dst - r0
        s0 = el[src].float() + er[dst].float()
        w = torch.exp(torch.clamp(_leaky(s0, slope) - m[dst].float(), max=0.0))
        q = edge_keep_mask(src, dst, seed, h, rate) if rate > 0.0 else None
        x = fs[src].to(dt).float().reshape(-1, h, f)
        parts["den"].append(_sum_rows(r1 - r0, local, w))
        wq = w if q is None else w * q
        parts["acc"].append(_sum_rows(r1 - r0, local, _round(x * _round(wq, bf16)[:, :, None], bf16)))
        if aux:
            wl = w * torch.where(s0 >= 0, 1.0, slope)
            parts["p"].append(_sum_rows(r1 - r0, local, wl))
            wlq = wl if q is None else wl * q
            parts["u"].append(_sum_rows(r1 - r0, local, _round(x * _round(wlq, bf16)[:, :, None], bf16)))
    dev = fs.device

    def cat(key, shape):
        return torch.cat(parts[key]) if parts[key] else torch.zeros(shape, device=dev)

    den = cat("den", (n, h))
    out = cat("acc", (n, h, f)) / den.clamp(min=_TINY)[:, :, None]
    u = cat("u", (n, h, f)).reshape(n, hf) if aux else None
    p = cat("p", (n, h)) if aux else None
    return out.reshape(n, hf), den, u, p


def _check_fwd(csr, el, er, m, fs, heads):
    n = csr.num_nodes
    if fs.dim() != 2 or fs.shape[0] != n or fs.shape[1] % heads:
        raise ValueError(f"fs must be (num_nodes={n}, heads*F), got {tuple(fs.shape)}")
    for name, t in (("el", el), ("er", er), ("m", m)):
        if tuple(t.shape) != (n, heads):
            raise ValueError(f"{name} must be ({n}, {heads}), got {tuple(t.shape)}")
    if not flash_supported(heads, fs.shape[1] // heads):
        raise ValueError(f"flash tiling unsupported for heads={heads}, F={fs.shape[1] // heads}")


def _f32(t: torch.Tensor, dev: torch.device, name: str) -> torch.Tensor:
    if t.device != dev:
        raise ValueError(f"{name} must be on {dev}, got {t.device}")
    return t.to(torch.float32).contiguous()


def flash_gat_fwd(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    m: torch.Tensor,
    fs: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
    stream_dtype=None,
    aux: bool = False,
    rate: float = 0.0,
    seed=None,
):
    """K8: ``(out, den, u, p)`` of the fused attention forward over ``csr``.

    ``el``, ``er`` and ``m`` are (N, H) f32 (``m`` from ``stability_max``),
    ``fs`` is (N, H*F). ``out`` and ``u`` are (N, H*F) f32, ``den`` and ``p``
    (N, H) f32; ``u`` and ``p`` are None without ``aux``. ``stream_dtype``
    as for ``spmm_rowmask``. ``rate`` > 0 selects the dropout mode, with
    ``seed`` (a Python int or a one-element integer tensor, best on the
    data's device) hashed in the kernel as ``edge_keep_mask`` hashes it.
    """
    _check_fwd(csr, el, er, m, fs, heads)
    rate = _check_rate(rate)
    if rate > 0.0 and seed is None:
        raise ValueError("the dropout mode (rate > 0) needs a seed")
    if fs.device.type == "cpu":
        return flash_gat_fwd_plain(csr, el, er, m, fs, heads, negative_slope, stream_dtype, aux, None, rate, seed)

    # the dropout mode's kernels are a library of their own (kernel_lib.DEFINES)
    lib = kernel_lib.load("flash_gat_fwd_dropout" if rate > 0.0 else "flash_gat_fwd", _FWD_SIGNATURES)
    dev = fs.device
    table, ld, bf16 = _gathered_table(csr, fs, stream_dtype, "K8")
    el32, er32, m32 = (_f32(t, dev, name) for t, name in ((el, "el"), (er, "er"), (m, "m")))
    n, hf = fs.shape
    out = torch.empty(n, hf, dtype=torch.float32, device=dev)
    den = torch.empty(n, heads, dtype=torch.float32, device=dev)
    u = torch.empty_like(out) if aux else None
    p = torch.empty_like(den) if aux else None
    if n == 0:
        return out, den, u, p
    item_row, item_beg, split_rows = _work_items(csr)
    if split_rows.numel():
        for t in (out, den, u, p):
            if t is not None:
                t.index_fill_(0, split_rows, 0.0)
    seed_t = _seed_tensor(seed, dev) if rate > 0.0 else None
    rc = lib.stg_flash_gat_fwd(
        csr.indptr.data_ptr(),
        csr.cols.data_ptr(),
        el32.data_ptr(),
        er32.data_ptr(),
        m32.data_ptr(),
        table.data_ptr(),
        int(bf16),
        item_row.data_ptr(),
        item_beg.data_ptr(),
        item_row.numel(),
        split_rows.data_ptr(),
        split_rows.numel(),
        out.data_ptr(),
        den.data_ptr(),
        None if u is None else u.data_ptr(),
        None if p is None else p.data_ptr(),
        heads,
        hf // heads,
        ld,
        float(negative_slope),
        ROW_CHUNK,
        None if seed_t is None else seed_t.data_ptr(),
        rate,
        _keep_scale(rate),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K8 (flash_gat_fwd) launch failed with cudaError {rc}")
    flash_gat_fwd.launches += 1
    if seed_t is not None:
        flash_gat_fwd.dropout_launches += 1
    return out, den, u, p


flash_gat_fwd.launches = 0  # kernel launches since the count was last reset
flash_gat_fwd.dropout_launches = 0  # of them, launches in the dropout mode


def flash_gat_bwd_plain(
    csr_t: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    m: torch.Tensor,
    c: torch.Tensor,
    gu: torch.Tensor,
    fs: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
    stream_dtype=None,
    edge_block: Optional[int] = None,
    rate: float = 0.0,
    seed=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9's plain version: ``(dfs, dl)`` over the transpose CSR, f32.

    Per transpose edge s -> d it recomputes ``w``, rounds where the kernels
    round (bf16 stream: ``gu``, ``w`` and their product; ``fs``, ``gu`` and
    their product for ``dw``), forms ``ds0 = w * (dw - c[d]) * lp`` in f32
    as the JAX kernel does, and sums in f64, rounded once to f32. With
    ``rate`` > 0 (the dropout mode) ``q`` is the keep mask of
    (rows_t, cols_t), the forward's (src, dst): ``dfs`` takes
    ``round(gu) * round(w * q)`` and ``ds0 = w * (dw * q - c[d]) * lp``
    (JAX's ``flash_gat.py:467-504``).
    """
    n, hf = gu.shape
    h = heads
    f = hf // h
    slope = float(negative_slope)
    bf16 = _stream_is_bf16(gu, stream_dtype)
    dt = torch.bfloat16 if bf16 else torch.float32
    rate = _check_rate(rate)
    dfs_parts, dl_parts = [], []
    for r0, r1, e0, e1 in _row_blocks(csr_t.host_arrays()[0], edge_block):
        src = csr_t.rows[e0:e1].long()
        dst = csr_t.cols[e0:e1].long()
        local = src - r0
        s0 = el[src].float() + er[dst].float()
        w = torch.exp(torch.clamp(_leaky(s0, slope) - m[dst].float(), max=0.0))
        q = edge_keep_mask(src, dst, seed, h, rate) if rate > 0.0 else None
        g = gu[dst].to(dt).float().reshape(-1, h, f)
        wq = w if q is None else w * q
        dfs_parts.append(_sum_rows(r1 - r0, local, _round(g * _round(wq, bf16)[:, :, None], bf16)))
        x = fs[src].to(dt).float().reshape(-1, h, f)
        dw = _round(x * g, bf16).double().sum(-1).float()
        if q is not None:
            dw = dw * q
        ds0 = w * (dw - c[dst].float()) * torch.where(s0 >= 0, 1.0, slope)
        dl_parts.append(_sum_rows(r1 - r0, local, ds0))
    if not dfs_parts:
        return torch.zeros(n, hf, device=gu.device), torch.zeros(n, h, device=gu.device)
    return torch.cat(dfs_parts).reshape(n, hf), torch.cat(dl_parts)


def flash_gat_bwd(
    csr_t: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    m: torch.Tensor,
    c: torch.Tensor,
    gu: torch.Tensor,
    fs: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
    stream_dtype=None,
    rate: float = 0.0,
    seed=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: ``(dfs, dl)`` of the fused attention, in one pass over the
    TRANSPOSE CSR ``csr_t`` (rows = sources).

    ``el``, ``er``, ``m`` and ``c`` are (N, H) f32, ``gu`` (the cotangent
    of the unnormalised numerator, ``g / den``) and the forward's ``fs``
    are (N, H*F). ``dfs`` is (N, H*F) f32 and ``dl`` (N, H) f32.
    ``stream_dtype`` as for ``spmm_rowmask`` (from ``gu``'s dtype when
    None). ``rate`` and ``seed``: the forward's dropout mode, whose mask
    the kernel hashes again from (row, col) = (src, dst).
    """
    _check_fwd(csr_t, el, er, m, gu, heads)
    if tuple(c.shape) != tuple(el.shape) or fs.shape != gu.shape:
        raise ValueError("c must be (N, H) and fs (N, H*F), as gu")
    rate = _check_rate(rate)
    if rate > 0.0 and seed is None:
        raise ValueError("the dropout mode (rate > 0) needs a seed")
    if gu.device.type == "cpu":
        return flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, heads, negative_slope, stream_dtype, None, rate,
                                   seed)

    lib = kernel_lib.load("flash_gat_bwd_dropout" if rate > 0.0 else "flash_gat_bwd", _BWD_SIGNATURES)
    dev = gu.device
    table, ld, bf16 = _gathered_table(csr_t, gu, stream_dtype, "K9")
    el32 = _f32(el, dev, "el")
    fields = torch.cat([_f32(er, dev, "er"), _f32(m, dev, "m"), _f32(c, dev, "c")], 1).contiguous()
    fs32 = _f32(fs, dev, "fs")  # rounded to the stream in the kernel
    n, hf = gu.shape
    dfs = torch.empty(n, hf, dtype=torch.float32, device=dev)
    dl = torch.empty(n, heads, dtype=torch.float32, device=dev)
    if n == 0:
        return dfs, dl
    item_row, item_beg, split_rows = _work_items(csr_t)
    if split_rows.numel():
        dfs.index_fill_(0, split_rows, 0.0)
        dl.index_fill_(0, split_rows, 0.0)
    seed_t = _seed_tensor(seed, dev) if rate > 0.0 else None
    rc = lib.stg_flash_gat_bwd(
        csr_t.indptr.data_ptr(),
        csr_t.cols.data_ptr(),
        el32.data_ptr(),
        fields.data_ptr(),
        table.data_ptr(),
        int(bf16),
        fs32.data_ptr(),
        item_row.data_ptr(),
        item_beg.data_ptr(),
        item_row.numel(),
        dfs.data_ptr(),
        dl.data_ptr(),
        heads,
        hf // heads,
        ld,
        float(negative_slope),
        ROW_CHUNK,
        None if seed_t is None else seed_t.data_ptr(),
        rate,
        _keep_scale(rate),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"K9 (flash_gat_bwd) launch failed with cudaError {rc}")
    flash_gat_bwd.launches += 1
    if seed_t is not None:
        flash_gat_bwd.dropout_launches += 1
    return dfs, dl


flash_gat_bwd.launches = 0  # kernel launches since the count was last reset
flash_gat_bwd.dropout_launches = 0  # of them, launches in the dropout mode


class _FlashGat(torch.autograd.Function):
    """K4 and K8 forward (K8's aux outputs only when a gradient is needed);
    K9 on the transpose CSR and node-level glue backward. ``m`` takes no
    gradient: softmax is invariant to the shift (the JAX VJP's d m = 0).
    With ``rate`` > 0, K8 and K9 run their dropout mode on ``seed``, which
    the backward keeps: the same mask comes back from the hash. ``der =
    <gu, u> - c p`` holds as it is, ``u`` carrying the mask and ``p`` not."""

    @staticmethod
    def forward(ctx, el, er, fs, csr, heads, negative_slope, stream_dtype, rate, seed):
        m = stability_max(csr, el, er, negative_slope)
        need_aux = any(ctx.needs_input_grad[:3])
        out, den, u, p = flash_gat_fwd(csr, el, er, m, fs, heads, negative_slope, stream_dtype, aux=need_aux,
                                       rate=rate, seed=seed)
        if need_aux:
            ctx.csr, ctx.heads = csr, heads
            ctx.negative_slope, ctx.stream_dtype = negative_slope, stream_dtype
            ctx.rate, ctx.seed = rate, seed
            ctx.save_for_backward(el, er, fs, m, den, out, u, p)
        return out

    @staticmethod
    def backward(ctx, g):
        el, er, fs, m, den, out, u, p = ctx.saved_tensors
        n, h = el.shape
        f = fs.shape[1] // h
        denom = den.clamp(min=_TINY)
        g2 = g.reshape(n, h, f).float()
        gu = (g2 / denom[:, :, None]).reshape(n, h * f)
        c = (g2 * out.reshape(n, h, f)).sum(-1) / denom
        der = (gu.reshape(n, h, f) * u.reshape(n, h, f)).sum(-1) - c * p
        dfs, dl = flash_gat_bwd(ctx.csr.transpose(), el, er, m, c, gu, fs, h, ctx.negative_slope, ctx.stream_dtype,
                                ctx.rate, ctx.seed)
        return dl.to(el.dtype), der.to(er.dtype), dfs.to(fs.dtype), None, None, None, None, None, None


def flash_gat_attention(
    csr: CSR,
    el: torch.Tensor,
    er: torch.Tensor,
    fs: torch.Tensor,
    heads: int,
    negative_slope: float = 0.2,
    stream_dtype=None,
    attn_drop: float = 0.0,
    drop_seed=None,
) -> torch.Tensor:
    """Fused GAT segment-softmax attention; returns (N, H*F) f32.

    ``el``, ``er`` (N, H) and ``fs`` (N, H*F), as the JAX
    ``flash_gat_attention`` takes them. Forward: K4, then K8; backward: K9
    on ``csr.transpose()``. Differentiable in ``el``, ``er`` and ``fs``.
    ``attn_drop`` > 0 drops the normalised coefficients inside K8 and K9
    by the hash of (src, dst, head, ``drop_seed``) (``edge_keep_mask``;
    ``drop_seed`` None is JAX's default seed, 0).
    """
    if not flash_supported(heads, fs.shape[-1] // heads):
        raise ValueError(f"flash tiling unsupported for heads={heads}, F={fs.shape[-1] // heads}")
    rate = _check_rate(attn_drop)
    seed = None
    if rate > 0.0:
        seed = _seed_tensor(0 if drop_seed is None else drop_seed, fs.device)
    if not torch.is_grad_enabled():  # no backward will come: no aux outputs
        el, er, fs = el.detach(), er.detach(), fs.detach()
    return _FlashGat.apply(el.float(), er.float(), fs, csr, heads, float(negative_slope), stream_dtype, rate, seed)
