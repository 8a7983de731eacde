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
// destination fields are about 75 GB, so as for K1 the time is set by how
// many random reads the card keeps in flight.
//
// What the design does about it (K2's shape):
//   - one warp per transpose row (a "work item", K1's items on the
//     transpose indptr), lanes across the H*F columns, 4 or 8 a lane: a
//     gathered gu row is one coalesced transaction group and feeds both dfs
//     and dw. fs[s] and el[s] are row-local: read once per item;
//   - the destination fields er, m and c are packed into one (N, 3H) node
//     table. Per 32 edges lane l takes head l % KH (KH = H rounded up to a
//     power of two) of the edges l / KH, l / KH + 32 / KH, ...: it reads
//     the three fields of its head (consecutive lanes read consecutive
//     heads of one row), recomputes w and w * lp, keeps them in a small
//     shared-memory table of the warp and sums (w * lp) * c in a register;
//   - dl needs dw per edge and head, a reduction across the head's lanes.
//     Instead of reducing per edge (K2's 5 shuffles an edge set its time),
//     each lane sums (w * lp) * fs[s, c] * gu[d, c] over the edges for its
//     own columns, and the warp reduces those sums by head once per item:
//     sum_e w lp (dw - c) = sum_c sum_e (w lp) fs gu  -  sum_e (w lp) c. The
//     roundings of the terms are the JAX kernel's; the sums run in another
//     order. In dropout mode q is a factor of the edge, so it moves inside
//     the column sum and stays out of the c term:
//       sum_e w lp (dw q - c) = sum_c sum_e (w lp q) fs gu - sum_e (w lp) c,
//     so the table holds w lp q where it held w lp, and the register sum of
//     (w lp) c is unchanged;
//   - in dropout mode the lane that forms w for (edge, head) hashes
//     (s, d, head, seed) to q in registers (no plane) and writes w * q,
//     rounded to the stream, where it wrote w. The mode is a template
//     parameter, compiled into a library of its own (STG_DROPOUT_MODE
//     below): the kernel without it is the one before;
//   - in bf16-stream mode the wrapper casts gu to a bf16 table once (row
//     stride padded to a multiple of 8); fs stays f32 and is rounded to bf16
//     as it is read, and the products are formed two at a time by bf16x2
//     multiplies;
//   - registers stay few enough for 4 blocks of 8 warps an SM (2 for the
//     rare f32 tiles of 8 columns a lane), and the edge loop is unrolled 4
//     deep, so each warp keeps 4 row reads in flight;
//   - a row with more than `chunk` edges is split into work items whose dfs
//     and dl partials meet by atomicAdd in rows the wrapper zeroed.
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
#include <type_traits>

#include "edge_keep_mask.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// The dropout mode this library holds: the wrapper builds this source twice,
// without and with -DSTG_DROPOUT_MODE=1 (two nvcc processes at once, each
// compiling half the template variants), and loads the one a call needs.
#ifndef STG_DROPOUT_MODE
#define STG_DROPOUT_MODE 0
#endif
constexpr bool kDropMode = STG_DROPOUT_MODE != 0;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An f32 value as the stream carries it.
template <typename T>
__device__ __forceinline__ float stream_value(float x);
template <>
__device__ __forceinline__ float stream_value<float>(float x) { return x; }
template <>
__device__ __forceinline__ float stream_value<__nv_bfloat16>(float x) {
  return round_to_bf16(x);
}

// A product of two stream values, formed in the stream's type.
template <typename T>
__device__ __forceinline__ float product(float a, float b);
template <>
__device__ __forceinline__ float product<float>(float a, float b) {
  return __fmul_rn(a, b);
}
template <>
__device__ __forceinline__ float product<__nv_bfloat16>(float a, float b) {
  return round_to_bf16(__fmul_rn(a, b));
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t x) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = x;
  return v;
}

// Column of the tile that lane `lane` holds in slot s. kVec: the lane's
// kSlots columns are consecutive (vector loads; needs ld % kSlots == 0 and
// a 16 B aligned table); otherwise they are lane, lane + 32, ...
template <int kSlots, bool kVec>
__device__ __forceinline__ int slot_col(int lane, int s) {
  return kVec ? lane * kSlots + s : s * 32 + lane;
}

// The lane's kSlots consecutive bf16 values of one table row, packed two to
// a word (zero past the row's stride).
template <int kSlots>
__device__ __forceinline__ void load_packed(const __nv_bfloat16* p, int lane,
                                            int ld, uint32_t raw[kSlots / 2]) {
  const int c = lane * kSlots;
  if (c < ld) {
    if (kSlots == 8) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + c));
      raw[0] = x.x;
      raw[1] = x.y;
      raw[2] = x.z;
      raw[3] = x.w;
    } else {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p + c));
      raw[0] = x.x;
      raw[1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSlots / 2; ++q) raw[q] = 0u;
  }
}

// The lane's kSlots values of one table row as f32 (zero past the row's
// width).
template <int kSlots, bool kVec>
__device__ __forceinline__ void load_slots(const float* p, int lane, int ld,
                                           int f, float v[kSlots]) {
  if (kVec) {
    const int c = lane * kSlots;
    if (c < ld) {
#pragma unroll
      for (int q = 0; q < kSlots / 4; ++q) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(p + c) + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int s = 0; s < kSlots; ++s) v[s] = 0.f;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int c = s * 32 + lane;
      v[s] = c < f ? __ldg(p + c) : 0.f;
    }
  }
}

template <int kSlots, bool kVec>
__device__ __forceinline__ void load_slots(const __nv_bfloat16* p, int lane,
                                           int ld, int f, float v[kSlots]) {
  const auto* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = slot_col<kSlots, kVec>(lane, s);
    v[s] = c < f ? bf16_bits_to_float(__ldg(q + c)) : 0.f;
  }
}

// Blocks an SM must hold: 4 (64 registers a thread) where a lane's row
// slice is small (packed bf16, or 4 columns); 2 for 8 unpacked columns,
// whose loads in flight need more registers.
template <typename T, int kSlots, bool kVec>
constexpr int min_blocks() {
  return (std::is_same<T, __nv_bfloat16>::value && kVec) || kSlots == 4 ? 4 : 2;
}

// kKH: H rounded up to a power of two (<= 16). kOneHead: all of a lane's
// columns lie in one head (H == 1, or consecutive columns with F a multiple
// of kSlots). kPacked: bf16 table read by vector loads, bf16x2 products.
// kDrop: the dropout mode (`seed` is read only there).
template <typename T, int kKH, int kSlots, bool kVec, bool kOneHead, bool kDrop>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  min_blocks<T, kSlots, kVec>())
flash_gat_bwd_kernel(const int32_t* __restrict__ indptr,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ el,
                     const float* __restrict__ fields,
                     const T* __restrict__ gu,
                     const float* __restrict__ fs,
                     const int32_t* __restrict__ item_row,
                     const int32_t* __restrict__ item_beg, int num_items,
                     float* __restrict__ dfs, float* __restrict__ dl, int h,
                     int f, int hf, int ld, float slope, int chunk,
                     const int64_t* __restrict__ seed, float rate,
                     float keep_scale) {
  constexpr bool kPacked = std::is_same<T, __nv_bfloat16>::value && kVec;
  constexpr int kStride = 32 / kKH;  // edges between one lane's weights
  // Per warp: w (w * q in dropout mode) as the stream carries it and w * lp
  // (w * lp * q) in f32, of the current 32 edges, by head.
  __shared__ float sw[kWarpsPerBlock][32][kKH];
  __shared__ float sa[kWarpsPerBlock][32][kKH];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + warp;
  if (item >= num_items) return;  // warp-uniform
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  const int64_t rh = static_cast<int64_t>(row) * h;
  const int64_t rc = static_cast<int64_t>(row) * hf;

  // The lane's role in the weight phase: head wh of edges wsub + t * kStride.
  const int wh = lane % kKH;
  const int wsub = lane / kKH;
  const bool wh_ok = wh < h;
  const float el_s = wh_ok ? __ldg(el + rh + wh) : 0.f;
  const uint32_t seed_u = kDrop ? static_cast<uint32_t>(seed[0]) : 0u;
  float cterm = 0.f;  // sum over this lane's edges of (w lp) c, head wh

  int hs[kSlots];  // the head of each of the lane's columns
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    hs[s] = min(slot_col<kSlots, kVec>(lane, s), hf - 1) / f;
  }
  // fs[s] on the lane's columns, as the stream carries it: bf16 pairs when
  // packed, else f32 values.
  uint32_t xp[kPacked ? kSlots / 2 : 1];
  float x[kPacked ? 1 : kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = slot_col<kSlots, kVec>(lane, s);
    const float v = c < hf ? stream_value<T>(__ldg(fs + rc + c)) : 0.f;
    if constexpr (kPacked) {
      if (s % 2 == 0) {
        xp[s / 2] = static_cast<uint32_t>(__float_as_uint(v) >> 16);
      } else {
        xp[s / 2] |= __float_as_uint(v) & 0xffff0000u;
      }
    } else {
      x[s] = v;
    }
  }
  float acc[kSlots];  // dfs
  float dla[kSlots];  // sum over edges of (w lp) * fs * gu, per column
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = dla[s] = 0.f;

  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);  // warp-uniform
    const int my_dst = lane < cnt ? cols[base + lane] : 0;
#pragma unroll
    for (int t = 0; t < kKH; ++t) {
      const int j = wsub + t * kStride;
      const int dst = __shfl_sync(kFull, my_dst, j);
      if (wh_ok && j < cnt) {
        const float* fd = fields + static_cast<int64_t>(dst) * 3 * h;
        const float s0 = el_s + __ldg(fd + wh);
        const float lk = s0 >= 0.f ? s0 : slope * s0;
        const float w = expf(fminf(lk - __ldg(fd + h + wh), 0.f));
        const float a = w * (s0 >= 0.f ? 1.f : slope);
        if (kDrop) {
          const float q = stg::edge_keep(static_cast<uint32_t>(row),
                                         static_cast<uint32_t>(dst), seed_u,
                                         static_cast<uint32_t>(wh), rate,
                                         keep_scale);
          sw[warp][j][wh] = stream_value<T>(__fmul_rn(w, q));
          sa[warp][j][wh] = __fmul_rn(a, q);
        } else {
          sw[warp][j][wh] = stream_value<T>(w);
          sa[warp][j][wh] = a;
        }
        cterm += a * __ldg(fd + 2 * h + wh);
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int dst = __shfl_sync(kFull, my_dst, j);
      const T* row_p = gu + static_cast<int64_t>(dst) * ld;
      float w[kSlots], a[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int hh = kOneHead ? hs[0] : hs[s];
        w[s] = (kOneHead && s > 0) ? w[0] : sw[warp][j][hh];
        a[s] = (kOneHead && s > 0) ? a[0] : sa[warp][j][hh];
      }
      if constexpr (kPacked) {
        uint32_t raw[kSlots / 2];
        load_packed<kSlots>(reinterpret_cast<const __nv_bfloat16*>(row_p), lane,
                            ld, raw);
#pragma unroll
        for (int q = 0; q < kSlots / 2; ++q) {
          const __nv_bfloat162 g2 = as_bf16x2(raw[q]);
          const __nv_bfloat162 r =
              __hmul2(g2, __floats2bfloat162_rn(w[2 * q], w[2 * q + 1]));
          acc[2 * q] += __low2float(r);
          acc[2 * q + 1] += __high2float(r);
          const __nv_bfloat162 d = __hmul2(as_bf16x2(xp[q]), g2);
          dla[2 * q] = fmaf(a[2 * q], __low2float(d), dla[2 * q]);
          dla[2 * q + 1] = fmaf(a[2 * q + 1], __high2float(d), dla[2 * q + 1]);
        }
      } else {
        float v[kSlots];
        load_slots<kSlots, kVec>(row_p, lane, ld, hf, v);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          acc[s] += product<T>(v[s], w[s]);
          dla[s] = fmaf(a[s], product<T>(x[s], v[s]), dla[s]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = slot_col<kSlots, kVec>(lane, s);
    if (c < hf) {
      if (split) {
        atomicAdd(dfs + rc + c, acc[s]);
      } else {
        dfs[rc + c] = acc[s];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kKH; ++hh) {
    if (hh < h) {  // warp-uniform
      float t = wh == hh ? -cterm : 0.f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (hs[s] == hh) t += dla[s];
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
  int h, f, hf, ld;
  float slope;
  int chunk;
  const int64_t* seed;  // null without dropout
  float rate, keep_scale;
  cudaStream_t stream;
};

template <typename T, int kKH, int kSlots, bool kVec, bool kOneHead, bool kDrop>
void launch_mode(const Args& a) {
  const dim3 grid((a.num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  flash_gat_bwd_kernel<T, kKH, kSlots, kVec, kOneHead, kDrop>
      <<<grid, kWarpsPerBlock * 32, 0, a.stream>>>(
          a.indptr, a.cols, a.el, a.fields, static_cast<const T*>(a.gu), a.fs,
          a.item_row, a.item_beg, a.num_items, a.dfs, a.dl, a.h, a.f, a.hf,
          a.ld, a.slope, a.chunk, a.seed, a.rate, a.keep_scale);
}

template <typename T, int kKH, int kSlots, bool kVec, bool kOneHead>
void launch_tile(const Args& a) {
  launch_mode<T, kKH, kSlots, kVec, kOneHead, kDropMode>(a);
}

template <typename T, int kKH, int kSlots>
void launch_slots(const Args& a) {
  // Vector loads need whole slot groups inside each row and 16 B rows.
  const bool vec = reinterpret_cast<uintptr_t>(a.gu) % 16 == 0 && a.ld % kSlots == 0;
  if (kKH == 1) {
    if (vec) launch_tile<T, kKH, kSlots, true, true>(a);
    else launch_tile<T, kKH, kSlots, false, true>(a);
  } else if (vec && a.f % kSlots == 0) {
    launch_tile<T, kKH, kSlots, true, true>(a);
  } else if (vec) {
    launch_tile<T, kKH, kSlots, true, false>(a);
  } else {
    launch_tile<T, kKH, kSlots, false, false>(a);
  }
}

template <typename T, int kKH>
void launch_heads(const Args& a) {
  if (a.hf <= 128) {
    launch_slots<T, kKH, 4>(a);
  } else {
    launch_slots<T, kKH, 8>(a);
  }
}

template <typename T>
void launch(const Args& a) {
  if (a.h <= 1) {
    launch_heads<T, 1>(a);
  } else if (a.h <= 2) {
    launch_heads<T, 2>(a);
  } else if (a.h <= 4) {
    launch_heads<T, 4>(a);
  } else if (a.h <= 8) {
    launch_heads<T, 8>(a);
  } else {
    launch_heads<T, 16>(a);
  }
}

}  // namespace

// Launches K9 on `stream` and returns cudaGetLastError() (0 on success).
// `indptr`/`cols` are the transpose CSR's; `el` is (n, h) f32, h <= 16;
// `fields` is (n, 3h) f32, [er | m | c]; `gu` is (n, ld) with ld >= hf =
// h * f, f32 or bf16 by `gu_bf16`, hf <= 256; `fs` is (n, hf) f32. `dfs` is
// (n, hf) and `dl` (n, h), f32: the caller zeroes the rows of split work
// items in both, and the kernel writes every element of every other row.
// `seed`, `rate` and `keep_scale` as for stg_flash_gat_fwd: given to the
// library built for the dropout mode, null to the other.
extern "C" int stg_flash_gat_bwd(const void* indptr, const void* cols,
                                 const void* el, const void* fields,
                                 const void* gu, int gu_bf16, const void* fs,
                                 const void* item_row, const void* item_beg,
                                 int num_items, void* dfs, void* dl, int h,
                                 int f, int ld, float slope, int chunk,
                                 const void* seed, float rate,
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
  a.slope = slope;
  a.chunk = chunk;
  a.seed = static_cast<const int64_t*>(seed);
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if ((seed != nullptr) != kDropMode) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (gu_bf16) {
    launch<__nv_bfloat16>(a);
  } else {
    launch<float>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
