// K8 on Hopper: the fused GAT attention forward ("flash-GAT"), per
// destination row d and head h of a CSR (rows = destinations, cols =
// sources), with m[d, h] the softmax's stability maximum computed before:
//
//   w_e      = exp(min(leaky(el[src_e, h] + er[d, h]) - m[d, h], 0))
//   den[d,h] = sum_e w_e
//   out[d,c] = sum_e w_e * fs[src_e, c] / max(den[d, h], FLT_MIN)
//
// for the columns c = h*F .. h*F+F-1 of head h. With `aux` it also returns
// the precursors of the backward's d er (the JAX package's "bwd_aux"):
//
//   u[d, c]  = sum_e (w_e * lp_e) * fs[src_e, c]      (unnormalised)
//   p[d, h]  = sum_e  w_e * lp_e
//
// where lp_e is 1 if el[src_e, h] + er[d, h] >= 0 and `slope` otherwise.
//
// Dropout mode (attention dropout on the normalised coefficients, the JAX
// kernel's `dropped`, flash_gat.py:294-333): with q_e the keep factor of
// (src_e, d, h) from edge_keep_mask.cuh (0 or 1 / (1 - rate)),
//
//   out[d,c] = sum_e (w_e q_e) fs[src_e, c] / max(den[d, h], FLT_MIN)
//   u[d, c]  = sum_e (w_e lp_e q_e) fs[src_e, c]
//
// while den and p keep the UNdropped weights: dropout acts on the
// normalised coefficients w_e / den, so it must not change den.
//
// Replaces the TPU kernel flash_gat._flash_fwd_kernel
// (stgraph_tpu/ops/flash_gat.py:191, reached from flash_gat_attention at
// pallas_call :663) on the GAT serving and training paths.
//
// What bounds it on an H100: memory. Per edge it does ~8 operations a head
// (one exp) and 2 (4 with aux) a feature column, while the gather of
// fs[src_e] reads a whole feature row per edge, spread over a table far
// larger than the 50 MB L2 (at ogbn-products size, 8 heads x 32, the bf16
// table is 1.25 GB and the gathered rows about 63 GB). The compulsory bytes
// (cols, el, er, m, the f32 fs table and the outputs once) give a bound of
// about 2.5 ms with aux; as for K1 the time is set by how many random row
// reads the card keeps in flight.
//
// The first design (a warp a row, a lane per column slice, per 32 edges
// first the 32 x H weights into a shared table, then the 32 rows) let the
// row gathers drain while each batch's weights formed, held 8 + 8 columns
// of one edge a lane in registers (spilling at 8 x 32 with aux) and walked
// one edge a warp step even where a row is 96 B (1 x 47 bf16: 12 of 32
// lanes loading). A second try, K1's walk with each round's weights formed
// from el loaded in the round, between its gathers and its products, lost
// at 8 x 32 (PERF.md §6): each round waited on its el loads. This design
// (csrc/flash_gat_walk.cuh):
//   - each edge takes a group of G lanes, one 16 B piece a lane (two for an
//     f32 row past 128 columns), G the row's 16 B pieces rounded up to a
//     power of two (ops/flash_gat.flash_lanes): a warp takes 32 / G edges a
//     step (8 x 32 bf16: 1; 1 x 47 bf16: 4; 8 x 8 f32: 2; 1 x 3 f32: 32),
//     and the groups' partial sums meet by shuffles once per work item;
//   - the item is walked in rounds of kRound edges (4 at 8 x 32, 16 at
//     1 x 47). Each warp keeps a small ring of three rounds in shared
//     memory that cp.async fills two rounds ahead with el[src, h] of each
//     (edge, head) pair (one pair a lane: head l % KH of edge l / KH, KH =
//     H rounded up to a power of two, several passes where kRound x KH >
//     32) and the edges' source ids; the cols of a round are loaded one
//     round before its copies start;
//   - a round issues its row gathers into registers (ids from the ring),
//     then, while they are in flight, each lane forms its pairs' weights
//     from el already landed against er[d, h] and m[d, h] kept in
//     registers and writes w and w * lp, as the stream carries them, back
//     into the pair's slot; only then does the warp multiply the rows, each
//     lane reading the weight of its columns' head. So no gather waits on
//     its weights and no weight waits on memory, and each weight is formed
//     once, not once per lane that uses it. Staging the rows themselves in
//     the ring (cp.async of 16 B pieces, two rounds ahead) was slower at
//     8 x 32, by the parts measured in PERF.md §6;
//   - in dropout mode the lane that forms w for (edge, head) also hashes
//     (src, d, head, seed) to q in registers (about a dozen integer
//     operations, no plane; src from the ring), writes w * q (and
//     w * lp * q) to the slot and adds the undropped w (and w * lp) to den
//     (and p). The mode is a template parameter, compiled into a library of
//     its own (STG_DROPOUT_MODE below);
//   - in bf16-stream mode the wrapper casts fs to a bf16 table once (row
//     stride padded to a multiple of 8, so every row is 16 B aligned), and
//     each product is one packed bf16x2 multiply (mul.rn.bf16x2: the exact
//     product rounded once, K1's check holds it bit-equal to rounding an
//     f32 product); an f32 table has its stride padded to a multiple of 4;
//   - a row with more than `chunk` edges (ops/spmm_kernels.FLASH_CHUNK) is
//     split into work items whose partial numerators, den, u and p simply
//     add (m is known before the pass): they meet by atomicAdd in rows the
//     wrapper zeroed, and a second small kernel divides those rows by their
//     den afterwards. The other rows are normalised by their own warp.
//
// Rounding matches the JAX kernel in interpret mode: with a bf16 stream,
// fs and the weight (w, or w * lp for u, each times q in dropout mode, the
// f32 product rounded once) are bf16 and their product is rounded to bf16,
// summed in f32; el, er, m, w, den and p stay f32. With an f32 stream every
// step is f32 (the product rounded, then added). Only the order of the f32
// sums differs.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libflash_gat_fwd-<hash>.so \
//        flash_gat_fwd.cu
// and, for the dropout mode, the same with -DSTG_DROPOUT_MODE=1 into
// libflash_gat_fwd_dropout-<hash>.so.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
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

// T: the stream (float or __nv_bfloat16); kG lanes an edge, kL 16 B loads a
// lane (flash_lanes); kOneHead: all of a lane's columns lie in one head;
// kDrop: the dropout mode (`seed` is read only there).
template <typename T, int kG, int kL, bool kOneHead, bool kAux, bool kDrop>
__global__ void __launch_bounds__(stg::flash::kMaxWarpsPerBlock * 32, stg::flash::kMinBlocks)
flash_gat_fwd_kernel(const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ el,
                     const float* __restrict__ er,
                     const float* __restrict__ m,
                     const T* __restrict__ fs,
                     const int32_t* __restrict__ item_row,
                     const int32_t* __restrict__ item_beg, int num_items,
                     float* __restrict__ out, float* __restrict__ den,
                     float* __restrict__ u, float* __restrict__ p, int h,
                     int f, int hf, int ld, int log_kh, float slope, int chunk,
                     const int64_t* __restrict__ seed, float rate,
                     float keep_scale) {
  using W = Walk<T, kG, kL, kOneHead, 8>;  // a pair's slot: el, then (w, w * lp)
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

  // the weight lanes' fields of this row
  const float er_d = walk.wh_ok() ? __ldg(er + rh + walk.wh()) : 0.f;
  const float m_d = walk.wh_ok() ? __ldg(m + rh + walk.wh()) : 0.f;
  const uint32_t seed_u = kDrop ? static_cast<uint32_t>(seed[0]) : 0u;
  float den_l = 0.f, p_l = 0.f;
  float acc[W::kC], uacc[W::kC];  // uacc: aux only
#pragma unroll
  for (int k = 0; k < W::kC; ++k) acc[k] = uacc[k] = 0.f;

  stg::flash::walk_rounds<W::kRound>(
      cols, beg, end - beg, lane,
      [&](int r, int my, int cnt) { walk.issue(el, h, 1, my, r, cnt); },
      [&](int r, int cnt) {
        // the round's gathers first ...
        uint4 q[W::kSteps][kL];
        walk.gather(fs, ld, r, cnt, q);
        // ... its weights while they are in flight, one (edge, head) pair a
        // lane, from el[src] landed in the pair's slot
#pragma unroll 1  // one pass a round on the main paths: unrolled, the hash's registers cost warps
        for (int t = 0; t < walk.passes(); ++t) {
          const int e = walk.we() + t * walk.wstride();
          if (walk.wh_ok() && e < W::kRound && e < cnt) {
            float2* sl = reinterpret_cast<float2*>(walk.slot(r, e, walk.wh()));
            const float s0 = sl->x + er_d;
            // leaky(s0) apart from the subtraction, so that no FMA rounds
            // them once: w must be the plain version's to the last bit,
            // since the bf16 stream rounds it
            const float lk = s0 >= 0.f ? s0 : __fmul_rn(slope, s0);
            const float w = expf(fminf(lk - m_d, 0.f));
            const float wl = w * (s0 >= 0.f ? 1.f : slope);
            const float qk =
                kDrop ? stg::edge_keep(static_cast<uint32_t>(walk.node(r, e)), static_cast<uint32_t>(row), seed_u,
                                       static_cast<uint32_t>(walk.wh()), rate, keep_scale)
                      : 1.f;
            den_l += w;
            if (kAux) p_l += wl;
            *sl = make_float2(W::stream(kDrop ? __fmul_rn(w, qk) : w), W::stream(kDrop ? __fmul_rn(wl, qk) : wl));
          }
        }
        __syncwarp();
        // ... then the products
#pragma unroll
        for (int s = 0; s < W::kSteps; ++s) {
          const int e = s * W::kEps + walk.grp();
          if (e < cnt && walk.active()) {
            float2 v[W::kNH];  // (w, w * lp) of the heads of the lane's columns
            walk.weights(r, e, v);
            walk.template madd<false>(q[s], v, acc);
            if (kAux) walk.template madd<true>(q[s], v, uacc);
          }
        }
      });

  walk.meet(acc);
  if (kAux) walk.meet(uacc);
  // den and p of head wh: the sum over the lanes that share it; lane l < h
  // then holds head l's
  for (int o = 1 << log_kh; o < 32; o <<= 1) {
    den_l += __shfl_xor_sync(kFull, den_l, o);
    if (kAux) p_l += __shfl_xor_sync(kFull, p_l, o);
  }
  if (lane < h) {
    if (split) {
      atomicAdd(den + rh + lane, den_l);
      if (kAux) atomicAdd(p + rh + lane, p_l);
    } else {
      den[rh + lane] = den_l;
      if (kAux) p[rh + lane] = p_l;
    }
  }
  float dens[W::kNH];  // each column's den (unused by split rows)
#pragma unroll
  for (int k = 0; k < W::kNH; ++k) dens[k] = __shfl_sync(kFull, den_l, walk.hs[k]);
  if (walk.grp() == 0 && walk.active()) {
    if (!split) {
#pragma unroll
      for (int k = 0; k < W::kC; ++k) acc[k] /= fmaxf(dens[kOneHead ? 0 : k], FLT_MIN);
    }
    walk.store(out + rc, acc, split);  // split rows: normalised by normalize_split_rows_kernel
    if (kAux) walk.store(u + rc, uacc, split);
  }
}

// Split rows, after every partial has landed: out /= max(den, FLT_MIN).
__global__ void normalize_split_rows_kernel(const int64_t* __restrict__ rows,
                                            int num_rows,
                                            const float* __restrict__ den,
                                            float* __restrict__ out, int h,
                                            int f, int hf) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(num_rows) * hf) return;
  const int64_t r = rows[i / hf];
  const int c = static_cast<int>(i % hf);
  out[r * hf + c] /= fmaxf(den[r * h + c / f], FLT_MIN);
}

struct Args {
  const int32_t* indptr;
  const int32_t* cols;
  const float* el;
  const float* er;
  const float* m;
  const void* fs;
  const int32_t* item_row;
  const int32_t* item_beg;
  int num_items;
  float* out;
  float* den;
  float* u;
  float* p;
  int h, f, hf, ld, log_kh;
  float slope;
  int chunk;
  const int64_t* seed;  // null without dropout
  float rate, keep_scale;
  cudaStream_t stream;
};

template <typename T, int kG, int kL, bool kOneHead, bool kAux>
cudaError_t launch_mode(const Args& a) {
  return stg::flash::launch_walk<Walk<T, kG, kL, kOneHead, 8>>(
      flash_gat_fwd_kernel<T, kG, kL, kOneHead, kAux, kDropMode>, a.num_items, a.log_kh, a.stream, a.indptr,
      a.cols, a.el, a.er, a.m, static_cast<const T*>(a.fs), a.item_row, a.item_beg, a.num_items, a.out, a.den,
      a.u, a.p, a.h, a.f, a.hf, a.ld, a.log_kh, a.slope, a.chunk, a.seed, a.rate, a.keep_scale);
}

template <typename T, int kG, int kL>
cudaError_t launch_geometry(const Args& a) {
  const bool one_head = a.h == 1 || a.f % Walk<T, kG, kL, true, 8>::kC == 0;
  if (one_head) {
    return a.u != nullptr ? launch_mode<T, kG, kL, true, true>(a) : launch_mode<T, kG, kL, true, false>(a);
  }
  return a.u != nullptr ? launch_mode<T, kG, kL, false, true>(a) : launch_mode<T, kG, kL, false, false>(a);
}

template <typename T>
cudaError_t launch(const Args& a, int g, int loads) {
  cudaError_t err = cudaErrorInvalidValue;
  stg::flash::dispatch<T>(g, loads, [&](auto geometry) {
    using Geo = decltype(geometry);
    err = launch_geometry<T, Geo::kG, Geo::kL>(a);
  });
  return err;
}

}  // namespace

// Launches K8 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments the kernel was not built for.
// `el`, `er`, `m`, `den` and `p` are (n, h) f32, h <= 16; `fs` is (n, ld),
// 16 B aligned, f32 or bf16 by `fs_bf16`, with ld >= hf = h * f a multiple
// of the 16 B load's columns (4 or 8), hf <= 256; `out` and `u` are (n, hf)
// f32. `u` and `p` are null without aux. `g` lanes take an edge with
// `loads` 16 B loads each (ops/flash_gat.flash_lanes). The caller zeroes the
// `num_split` rows listed in `split_rows` (int64) in out, den, u and p; the
// kernel writes every element of every other row. `seed` (one int64 on the
// device, its low 32 bits the hash's seed) is given, with `rate` and
// `keep_scale` = f32(1 / (1 - rate)), to the library built for the dropout
// mode, and null to the other; a call to the wrong library launches
// nothing.
extern "C" int stg_flash_gat_fwd(const void* indptr, const void* cols,
                                 const void* el, const void* er,
                                 const void* m, const void* fs, int fs_bf16,
                                 const void* item_row, const void* item_beg,
                                 int num_items, const void* split_rows,
                                 int num_split, void* out, void* den, void* u,
                                 void* p, int h, int f, int ld, float slope,
                                 int chunk, int g, int loads, const void* seed,
                                 float rate, float keep_scale, void* stream) {
  Args a;
  a.indptr = static_cast<const int32_t*>(indptr);
  a.cols = static_cast<const int32_t*>(cols);
  a.el = static_cast<const float*>(el);
  a.er = static_cast<const float*>(er);
  a.m = static_cast<const float*>(m);
  a.fs = fs;
  a.item_row = static_cast<const int32_t*>(item_row);
  a.item_beg = static_cast<const int32_t*>(item_beg);
  a.num_items = num_items;
  a.out = static_cast<float*>(out);
  a.den = static_cast<float*>(den);
  a.u = static_cast<float*>(u);
  a.p = static_cast<float*>(p);
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
  if ((seed != nullptr) != kDropMode || (a.u != nullptr) != (a.p != nullptr) ||
      !stg::flash::geometry_ok(h, f, ld, fs, fs_bf16, g, loads, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = fs_bf16 ? launch<__nv_bfloat16>(a, g, loads) : launch<float>(a, g, loads);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_split > 0) {
    const int64_t total = static_cast<int64_t>(num_split) * a.hf;
    normalize_split_rows_kernel<<<static_cast<unsigned>((total + 255) / 256),
                                  256, 0, a.stream>>>(
        static_cast<const int64_t*>(split_rows), num_split, a.den, a.out, h, f,
        a.hf);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

__global__ void edge_keep_mask_kernel(const int32_t* __restrict__ src,
                                      const int32_t* __restrict__ dst,
                                      int64_t e, int h,
                                      const int64_t* __restrict__ seed,
                                      float rate, float keep_scale,
                                      float* __restrict__ out) {
  const uint32_t seed_u = static_cast<uint32_t>(seed[0]);
  const int64_t total = e * h;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t k = i / h;
    out[i] = stg::edge_keep(static_cast<uint32_t>(src[k]),
                            static_cast<uint32_t>(dst[k]), seed_u,
                            static_cast<uint32_t>(i - k * h), rate,
                            keep_scale);
  }
}

}  // namespace

// Writes the (e, h) f32 keep mask of the edges (src[k], dst[k]) from the
// same device function K8 and K9 use, so that a check can hold the
// in-kernel hash against the port's edge_keep_mask bit for bit. Not on any
// model's path. Returns cudaGetLastError().
extern "C" int stg_edge_keep_mask(const void* src, const void* dst, long long e,
                                  int h, const void* seed, float rate,
                                  float keep_scale, void* out, void* stream) {
  const int64_t total = static_cast<int64_t>(e) * h;
  if (total > 0) {
    const int64_t blocks = (total + 255) / 256;
    edge_keep_mask_kernel<<<static_cast<unsigned>(blocks < 65535 * 16 ? blocks : 65535 * 16),
                            256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst), e, h,
        static_cast<const int64_t*>(seed), rate, keep_scale,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
