// K9 on Hopper: the fused GAT attention backward over the TRANSPOSE CSR
// (rows = sources s, cols = destinations d). For each transpose edge s -> d
// and head h it recomputes the forward's weight exactly,
//
//   w  = exp(min(leaky(el[s, h] + er[d, h]) - m[d, h], 0))
//   lp = 1 if el[s, h] + er[d, h] >= 0, else slope
//
// and accumulates, per source row s,
//
//   dfs[s, c] += w * gu[d, c]                      (c in head h's columns)
//   dl[s, h]  += w * (dw - c[d, h]) * lp,   dw = < fs[s]|h , gu[d]|h >
//
// gu = g / den and c = <g, out> / den are the node-level cotangents of the
// forward's numerator and normaliser (computed in plain torch, as the JAX
// package does); d er comes from the forward's aux outputs and needs no
// edge pass.
//
// Dropout mode (the JAX kernel's `dropped`, flash_gat.py:467-504): with
// q the keep factor of (s, d, h) from edge_keep_mask.cuh, the same hash of
// the same (src, dst) pair as the forward's (the transpose row is the
// source), so the forward's mask comes back without a permutation:
//
//   dfs[s, c] += (w q) * gu[d, c]
//   dl[s, h]  += w * (dw q - c[d, h]) * lp
//
// The forward's numerator took w q and its denominator w: out's cotangent
// reaches fs through w q, and reaches the score through both, the
// numerator's share scaled by q (dw q) and the normaliser's (c) not.
//
// Replaces the TPU kernel flash_gat._flash_bwd_b_kernel
// (stgraph_tpu/ops/flash_gat.py:365, reached from flash_gat_attention at
// pallas_call :663) on the GAT training path.
//
// What bounds it on an H100: memory. Per edge it does ~9 operations a head
// (one exp) and 4 a feature column (the dfs product and sum, the dw product
// and sum), while the gather of gu[d] reads a whole row per edge from a
// table far larger than the 50 MB L2. The compulsory bytes (cols, el, er, m,
// c, the f32 gu and fs tables and the outputs once) give a bound of about
// 2.5 ms at ogbn-products size with 8 heads x 32; the gathered rows and
// destination fields are about 80 GB, so as for K1 the time is set by how
// many random reads the card keeps in flight.
//
// The first design (K2's shape: a warp a row, per 32 edges first the
// weights into a shared table, then the 32 gu rows) let the gathers drain
// while each batch's weights formed, held 8 + 8 columns and fs's slice a
// lane in registers (35 of its 80 instances spilled, up to 144 B) and
// walked one edge a warp step at every width. This design is K8's walk
// (csrc/flash_gat_walk.cuh; flash_gat_fwd.cu says why):
//   - each edge takes a group of G lanes, one 16 B piece of gu[d] a lane
//     (two for an f32 row past 128 columns), so a warp takes 32 / G edges
//     a step; fs[s] and el[s] are row-local: read once per item, fs rounded
//     to the stream and, in bf16, packed two to a word;
//   - the destination fields are packed into one (N, H, 4) node table,
//     (er, m, c, 0) of each node and head. Each warp's small ring of three
//     rounds in shared memory is filled by cp.async two rounds ahead: one
//     16 B copy of (er, m, c) for each (edge, head) pair (one pair a lane:
//     head l % KH of edge l / KH, KH = H rounded up to a power of two) and
//     the edges' destination ids;
//   - a round issues its gu row gathers into registers, then, while they
//     are in flight, each lane recomputes its pairs' w and w * lp from the
//     landed fields, writes them back into the pair's slot and sums
//     (w * lp) * c in a register; then the warp multiplies the rows;
//   - dl needs dw per edge and head, a reduction across the head's lanes.
//     Instead of reducing per edge, each lane sums (w * lp) * fs[s, c] *
//     gu[d, c] over the edges for its own columns, and the warp reduces
//     those sums by head once per item:
//       sum_e w lp (dw - c) = sum_c sum_e (w lp) fs gu  -  sum_e (w lp) c.
//     The roundings of the terms are the JAX kernel's; the sums run in
//     another order. In dropout mode q is a factor of the edge, so it moves
//     inside the column sum and stays out of the c term:
//       sum_e w lp (dw q - c) = sum_c sum_e (w lp q) fs gu - sum_e (w lp) c,
//     so the slot holds w lp q where it held w lp, and the register sum of
//     (w lp) c is unchanged;
//   - in dropout mode the lane that forms w for (edge, head) hashes
//     (s, d, head, seed) to q in registers (no plane; d from the ring) and
//     writes w * q, rounded to the stream, where it wrote w. The mode is a
//     template parameter, compiled into a library of its own
//     (STG_DROPOUT_MODE below);
//   - in bf16-stream mode the wrapper casts gu to a bf16 table once (row
//     stride padded to a multiple of 8), and the products are packed bf16x2
//     multiplies (mul.rn.bf16x2, the exact product rounded once); an f32
//     table has its stride padded to a multiple of 4;
//   - a row with more than `chunk` edges (ops/spmm_kernels.FLASH_CHUNK) is
//     split into work items whose dfs and dl partials meet by atomicAdd in
//     rows the wrapper zeroed; every other row is stored once.
//
// Rounding matches the JAX kernel in interpret mode: with a bf16 stream,
// dfs's product of bf16 gu and bf16 w (w * q in dropout mode, the f32
// product rounded once) and dw's products of bf16 fs and bf16 gu are
// rounded to bf16 (once, by the bf16x2 multiply) and summed in f32; el, er,
// m, c, w, q and dl stay f32. With an f32 stream every step is f32.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libflash_gat_bwd-<hash>.so \
//        flash_gat_bwd.cu
// and, for the dropout mode, the same with -DSTG_DROPOUT_MODE=1 into
// libflash_gat_bwd_dropout-<hash>.so.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "edge_keep_mask.cuh"
#include "flash_gat_walk.cuh"

namespace {

using stg::flash::kFull;
using stg::flash::Walk;

// The dropout mode this library holds: the wrapper builds this source twice,
// without and with -DSTG_DROPOUT_MODE=1 (two nvcc processes at once, each
// compiling half the template variants), and loads the one a call needs.
#ifndef STG_DROPOUT_MODE
#define STG_DROPOUT_MODE 0
#endif
constexpr bool kDropMode = STG_DROPOUT_MODE != 0;

// T: the stream of gu (float or __nv_bfloat16); kG lanes an edge, kL 16 B
// loads a lane (flash_lanes); kOneHead: all of a lane's columns lie in one
// head; kDrop: the dropout mode (`seed` is read only there).
template <typename T, int kG, int kL, bool kOneHead, bool kDrop>
__global__ void __launch_bounds__(stg::flash::kMaxWarpsPerBlock * 32, stg::flash::kMinBlocks)
flash_gat_bwd_kernel(const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ el,
                     const float* __restrict__ fields,
                     const T* __restrict__ gu,
                     const float* __restrict__ fs,
                     const int32_t* __restrict__ item_row,
                     const int32_t* __restrict__ item_beg, int num_items,
                     float* __restrict__ dfs, float* __restrict__ dl, int h,
                     int f, int hf, int ld, int log_kh, float slope, int chunk,
                     const int64_t* __restrict__ seed, float rate,
                     float keep_scale) {
  using W = Walk<T, kG, kL, kOneHead, 16>;  // a pair's slot: er, m, c, then (w q, w lp q)
  extern __shared__ __align__(16) char flash_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= num_items) return;  // warp-uniform
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  const int64_t rh = static_cast<int64_t>(row) * h;
  const int64_t rc = static_cast<int64_t>(row) * hf;
  const W walk(lane, h, f, hf, log_kh,
               flash_smem + warp * stg::flash::kStages * W::stage_bytes(log_kh));

  const float el_s = walk.wh_ok() ? __ldg(el + rh + walk.wh()) : 0.f;
  const uint32_t seed_u = kDrop ? static_cast<uint32_t>(seed[0]) : 0u;
  float cterm = 0.f;  // sum over this lane's pairs of (w lp) c, head wh

  // fs[s] on the lane's columns, as the stream carries it: bf16 pairs, or
  // f32 bits
  uint32_t xw[W::kC];
#pragma unroll
  for (int k = 0; k < W::kC; ++k) {
    const int c = walk.col0() + k;
    const float v = c < hf ? W::stream(__ldg(fs + rc + c)) : 0.f;
    if constexpr (W::kBf16) {
      if (k % 2 == 0) {
        xw[k / 2] = __float_as_uint(v) >> 16;
      } else {
        xw[k / 2] |= __float_as_uint(v) & 0xffff0000u;
      }
    } else {
      xw[k] = __float_as_uint(v);
    }
  }
  float acc[W::kC];  // dfs
  float dla[W::kC];  // sum over edges of (w lp q) * fs * gu, per column
#pragma unroll
  for (int k = 0; k < W::kC; ++k) acc[k] = dla[k] = 0.f;

  stg::flash::walk_rounds<W::kRound>(
      cols, beg, end - beg, lane,
      [&](int r, int my, int cnt) { walk.issue(fields, 4 * h, 4, my, r, cnt); },
      [&](int r, int cnt) {
        // the round's gathers first ...
        uint4 q[W::kSteps][kL];
        walk.gather(gu, ld, r, cnt, q);
        // ... its weights while they are in flight, one (edge, head) pair a
        // lane, from the destination's [er, m, c] landed in the pair's slot
#pragma unroll 1  // one pass a round on the main paths: unrolled, the hash's registers cost warps
        for (int t = 0; t < walk.passes(); ++t) {
          const int e = walk.we() + t * walk.wstride();
          if (walk.wh_ok() && e < W::kRound && e < cnt) {
            float4* sl = reinterpret_cast<float4*>(walk.slot(r, e, walk.wh()));
            const float4 fd = *sl;
            const float s0 = el_s + fd.x;
            // leaky(s0) apart from the subtraction (no FMA): w as the forward's
            const float lk = s0 >= 0.f ? s0 : __fmul_rn(slope, s0);
            const float w = expf(fminf(lk - fd.y, 0.f));
            const float a = w * (s0 >= 0.f ? 1.f : slope);
            const float qk =
                kDrop ? stg::edge_keep(static_cast<uint32_t>(row), static_cast<uint32_t>(walk.node(r, e)), seed_u,
                                       static_cast<uint32_t>(walk.wh()), rate, keep_scale)
                      : 1.f;
            cterm += a * fd.z;
            *reinterpret_cast<float2*>(sl) =
                make_float2(W::stream(kDrop ? __fmul_rn(w, qk) : w), kDrop ? __fmul_rn(a, qk) : a);
          }
        }
        __syncwarp();
        // ... then the products
#pragma unroll
        for (int s = 0; s < W::kSteps; ++s) {
          const int e = s * W::kEps + walk.grp();
          if (e < cnt && walk.active()) {
            float2 v[W::kNH];  // (w q, w lp q) of the heads of the lane's columns
            walk.weights(r, e, v);
            walk.template madd<false>(q[s], v, acc);
            walk.madd_dot(q[s], xw, v, dla);
          }
        }
      });

  walk.meet(acc);
  walk.meet(dla);
  if (walk.grp() == 0 && walk.active()) walk.store(dfs + rc, acc, split);
  // dl[s, hh] = sum of dla over head hh's columns - sum of cterm over the
  // lanes of head hh
  for (int hh = 0; hh < h; ++hh) {  // warp-uniform
    float t = walk.wh() == hh ? -cterm : 0.f;
    if (walk.grp() == 0) {
#pragma unroll
      for (int k = 0; k < W::kC; ++k) {
        if (walk.hs[kOneHead ? 0 : k] == hh && walk.col0() + k < hf) t += dla[k];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    if (lane == 0) {
      if (split) {
        atomicAdd(dl + rh + hh, t);
      } else {
        dl[rh + hh] = t;
      }
    }
  }
}

struct Args {
  const int32_t* indptr;
  const int32_t* cols;
  const float* el;
  const float* fields;
  const void* gu;
  const float* fs;
  const int32_t* item_row;
  const int32_t* item_beg;
  int num_items;
  float* dfs;
  float* dl;
  int h, f, hf, ld, log_kh;
  float slope;
  int chunk;
  const int64_t* seed;  // null without dropout
  float rate, keep_scale;
  cudaStream_t stream;
};

template <typename T, int kG, int kL, bool kOneHead>
cudaError_t launch_mode(const Args& a) {
  return stg::flash::launch_walk<Walk<T, kG, kL, kOneHead, 16>>(
      flash_gat_bwd_kernel<T, kG, kL, kOneHead, kDropMode>, a.num_items, a.log_kh, a.stream, a.indptr, a.cols,
      a.el, a.fields, static_cast<const T*>(a.gu), a.fs, a.item_row, a.item_beg, a.num_items, a.dfs, a.dl, a.h,
      a.f, a.hf, a.ld, a.log_kh, a.slope, a.chunk, a.seed, a.rate, a.keep_scale);
}

template <typename T>
cudaError_t launch(const Args& a, int g, int loads) {
  cudaError_t err = cudaErrorInvalidValue;
  stg::flash::dispatch<T>(g, loads, [&](auto geometry) {
    using Geo = decltype(geometry);
    const bool one_head = a.h == 1 || a.f % Walk<T, Geo::kG, Geo::kL, true, 16>::kC == 0;
    err = one_head ? launch_mode<T, Geo::kG, Geo::kL, true>(a) : launch_mode<T, Geo::kG, Geo::kL, false>(a);
  });
  return err;
}

}  // namespace

// Launches K9 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel was not built for.
// `indptr`/`cols` are the transpose CSR's; `el` is (n, h) f32, h <= 16;
// `fields` is (n, h, 4) f32, 16 B aligned: (er, m, c, 0) of each node and
// head, so that one 16 B copy brings a pair's three; `gu` is (n, ld), 16 B aligned, f32
// or bf16 by `gu_bf16`, with ld >= hf = h * f a multiple of the 16 B load's
// columns, hf <= 256; `fs` is (n, hf) f32. `g` lanes take an edge with
// `loads` 16 B loads each (ops/flash_gat.flash_lanes). `dfs` is (n, hf) and
// `dl` (n, h), f32: the caller zeroes the rows of split work items in both,
// and the kernel writes every element of every other row. `seed`, `rate`
// and `keep_scale` as for stg_flash_gat_fwd: given to the library built
// for the dropout mode, null to the other.
extern "C" int stg_flash_gat_bwd(const void* indptr, const void* cols,
                                 const void* el, const void* fields,
                                 const void* gu, int gu_bf16, const void* fs,
                                 const void* item_row, const void* item_beg,
                                 int num_items, void* dfs, void* dl, int h,
                                 int f, int ld, float slope, int chunk, int g,
                                 int loads, const void* seed, float rate,
                                 float keep_scale, void* stream) {
  Args a;
  a.indptr = static_cast<const int32_t*>(indptr);
  a.cols = static_cast<const int32_t*>(cols);
  a.el = static_cast<const float*>(el);
  a.fields = static_cast<const float*>(fields);
  a.gu = gu;
  a.fs = static_cast<const float*>(fs);
  a.item_row = static_cast<const int32_t*>(item_row);
  a.item_beg = static_cast<const int32_t*>(item_beg);
  a.num_items = num_items;
  a.dfs = static_cast<float*>(dfs);
  a.dl = static_cast<float*>(dl);
  a.h = h;
  a.f = f;
  a.hf = h * f;
  a.ld = ld;
  a.log_kh = stg::flash::log2_ceil(h);
  a.slope = slope;
  a.chunk = chunk;
  a.seed = static_cast<const int64_t*>(seed);
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if ((seed != nullptr) != kDropMode || !stg::flash::geometry_ok(h, f, ld, gu, gu_bf16, g, loads, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = gu_bf16 ? launch<__nv_bfloat16>(a, g, loads) : launch<float>(a, g, loads);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
