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
// reads the card keeps in flight, so the design keeps registers low enough
// for many warps per SM and unrolls the row loop 4 deep.
//
// What the design does about it (K1's, with the softmax inside):
//   - one warp per destination row (a "work item"), lanes across the H*F
//     columns, 4 (H*F <= 128) or 8 (<= 256) columns a lane: one gathered
//     row is one coalesced transaction group, and the weights are applied
//     inside the kernel (the TPU kernel needs an XLA pre-gather plane and
//     one-hot matmuls to reach the destination fields);
//   - per 32 edges the warp first forms the 32 x H weights: lane l takes
//     head l % KH (KH = H rounded up to a power of two) of the edges
//     l / KH, l / KH + 32 / KH, ..., reading el[src, h] (consecutive lanes
//     read consecutive heads of one row) and keeping er[d, h], m[d, h] and
//     its running den and p in four registers; it writes w (and w * lp) as
//     the stream carries them into a small shared-memory table of the warp.
//     den and p are reduced across the lanes of a head once per item;
//   - then the warp walks the 32 edges: src by shuffle, one row load, and
//     the weight of the lane's head from the table (one read when all of a
//     lane's columns lie in one head, the usual case);
//   - in dropout mode the lane that forms w for (edge, head) also hashes
//     (src, d, head, seed) to q in registers (about a dozen integer
//     operations, no plane), writes w * q (and w * lp * q) to the table
//     and adds the undropped w (and w * lp) to den (and p). The mode is a
//     template parameter, compiled into a library of its own
//     (STG_DROPOUT_MODE below): the kernel without it is the one before;
//   - in bf16-stream mode the wrapper casts fs to a bf16 table once (row
//     stride padded to a multiple of 8), halving the gathered bytes, and the
//     products are formed two at a time by bf16x2 multiplies;
//   - a row with more than `chunk` edges is split into work items whose
//     partial numerators, den, u and p simply add (m is known before the
//     pass): they meet by atomicAdd in rows the wrapper zeroed, and a
//     second small kernel divides those rows by their den afterwards. The
//     other rows are normalised by their own warp at the end.
//
// Rounding matches the JAX kernel in interpret mode: with a bf16 stream,
// fs and the weight (w, or w * lp for u, each times q in dropout mode, the
// f32 product rounded once) are bf16 and their product is
// rounded to bf16 (a bf16x2 multiply rounds the exact product once, as
// rounding an f32 product of two bf16 values does), summed in f32; el, er,
// m, w, den and p stay f32. With an f32 stream every step is f32. Only the
// order of the f32 sums differs.
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

// acc_lo/hi += the bf16-rounded products of the two bf16 values packed in
// `x` with the bf16 values w_lo and w_hi.
__device__ __forceinline__ void madd_bf16x2(uint32_t x, float w_lo, float w_hi,
                                            float& acc_lo, float& acc_hi) {
  __nv_bfloat162 xv;
  *reinterpret_cast<uint32_t*>(&xv) = x;
  const __nv_bfloat162 r = __hmul2(xv, __floats2bfloat162_rn(w_lo, w_hi));
  acc_lo += __low2float(r);
  acc_hi += __high2float(r);
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
template <typename T, int kKH, int kSlots, bool kVec, bool kOneHead, bool kAux,
          bool kDrop>
__global__ void __launch_bounds__(kWarpsPerBlock * 32,
                                  min_blocks<T, kSlots, kVec>())
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
                     int f, int hf, int ld, float slope, int chunk,
                     const int64_t* __restrict__ seed, float rate,
                     float keep_scale) {
  constexpr bool kPacked = std::is_same<T, __nv_bfloat16>::value && kVec;
  constexpr int kStride = 32 / kKH;  // edges between one lane's weights
  // Per warp: the weights of the current 32 edges, by head, as the stream
  // carries them (w, and w * lp for u).
  __shared__ float sw[kWarpsPerBlock][32][kKH];
  __shared__ float swl[kWarpsPerBlock][32][kAux ? kKH : 1];
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
  const float er_d = wh_ok ? __ldg(er + rh + wh) : 0.f;
  const float m_d = wh_ok ? __ldg(m + rh + wh) : 0.f;
  const uint32_t seed_u = kDrop ? static_cast<uint32_t>(seed[0]) : 0u;
  float den_l = 0.f, p_l = 0.f;

  int hs[kSlots];  // the head of each of the lane's columns
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    hs[s] = min(slot_col<kSlots, kVec>(lane, s), hf - 1) / f;
  }
  float acc[kSlots], uacc[kAux ? kSlots : 1];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
#pragma unroll
  for (int s = 0; s < (kAux ? kSlots : 1); ++s) uacc[s] = 0.f;

  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);  // warp-uniform
    const int my_src = lane < cnt ? cols[base + lane] : 0;
#pragma unroll
    for (int t = 0; t < kKH; ++t) {
      const int j = wsub + t * kStride;
      const int src = __shfl_sync(kFull, my_src, j);
      if (wh_ok && j < cnt) {
        const float s0 = __ldg(el + static_cast<int64_t>(src) * h + wh) + er_d;
        const float lk = s0 >= 0.f ? s0 : slope * s0;
        const float w = expf(fminf(lk - m_d, 0.f));
        const float q =
            kDrop ? stg::edge_keep(static_cast<uint32_t>(src),
                                   static_cast<uint32_t>(row), seed_u,
                                   static_cast<uint32_t>(wh), rate, keep_scale)
                  : 1.f;
        den_l += w;
        sw[warp][j][wh] = stream_value<T>(kDrop ? __fmul_rn(w, q) : w);
        if (kAux) {
          const float wl = w * (s0 >= 0.f ? 1.f : slope);
          p_l += wl;
          swl[warp][j][wh] = stream_value<T>(kDrop ? __fmul_rn(wl, q) : wl);
        }
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int src = __shfl_sync(kFull, my_src, j);
      const T* row_p = fs + static_cast<int64_t>(src) * ld;
      float w[kSlots], wl[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int hh = kOneHead ? hs[0] : hs[s];
        w[s] = (kOneHead && s > 0) ? w[0] : sw[warp][j][hh];
        if (kAux) wl[s] = (kOneHead && s > 0) ? wl[0] : swl[warp][j][hh];
      }
      if constexpr (kPacked) {
        uint32_t raw[kSlots / 2];
        load_packed<kSlots>(reinterpret_cast<const __nv_bfloat16*>(row_p), lane,
                            ld, raw);
#pragma unroll
        for (int q = 0; q < kSlots / 2; ++q) {
          madd_bf16x2(raw[q], w[2 * q], w[2 * q + 1], acc[2 * q], acc[2 * q + 1]);
          if (kAux) {
            madd_bf16x2(raw[q], wl[2 * q], wl[2 * q + 1], uacc[2 * q],
                        uacc[2 * q + 1]);
          }
        }
      } else {
        float v[kSlots];
        load_slots<kSlots, kVec>(row_p, lane, ld, hf, v);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          acc[s] += product<T>(v[s], w[s]);
          if (kAux) uacc[s] += product<T>(v[s], wl[s]);
        }
      }
    }
    __syncwarp();
  }

  // den and p of head wh: the sum over the lanes that share it. Lane l < h
  // then holds head l's (l % kKH == l).
#pragma unroll
  for (int o = kKH; o < 32; o <<= 1) {
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
  float dens[kSlots];  // each column's den (unused by split rows)
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    dens[s] = (kOneHead && s > 0) ? dens[0]
                                  : __shfl_sync(kFull, den_l, kOneHead ? hs[0] : hs[s]);
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = slot_col<kSlots, kVec>(lane, s);
    if (c < hf) {
      if (split) {  // normalised by normalize_split_rows_kernel
        atomicAdd(out + rc + c, acc[s]);
        if (kAux) atomicAdd(u + rc + c, uacc[s]);
      } else {
        out[rc + c] = acc[s] / fmaxf(dens[s], FLT_MIN);
        if (kAux) u[rc + c] = uacc[s];
      }
    }
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
  int h, f, hf, ld;
  float slope;
  int chunk;
  const int64_t* seed;  // null without dropout
  float rate, keep_scale;
  cudaStream_t stream;
};

template <typename T, int kKH, int kSlots, bool kVec, bool kOneHead, bool kAux,
          bool kDrop>
void launch_mode(const Args& a) {
  const dim3 grid((a.num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  flash_gat_fwd_kernel<T, kKH, kSlots, kVec, kOneHead, kAux, kDrop>
      <<<grid, block, 0, a.stream>>>(
          a.indptr, a.cols, a.el, a.er, a.m, static_cast<const T*>(a.fs),
          a.item_row, a.item_beg, a.num_items, a.out, a.den, a.u, a.p, a.h,
          a.f, a.hf, a.ld, a.slope, a.chunk, a.seed, a.rate, a.keep_scale);
}

template <typename T, int kKH, int kSlots, bool kVec, bool kOneHead>
void launch_tile(const Args& a) {
  if (a.u != nullptr) {
    launch_mode<T, kKH, kSlots, kVec, kOneHead, true, kDropMode>(a);
  } else {
    launch_mode<T, kKH, kSlots, kVec, kOneHead, false, kDropMode>(a);
  }
}

template <typename T, int kKH, int kSlots>
void launch_slots(const Args& a) {
  // Vector loads need whole slot groups inside each row and 16 B rows.
  const bool vec = reinterpret_cast<uintptr_t>(a.fs) % 16 == 0 && a.ld % kSlots == 0;
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

// Launches K8 on `stream` and returns cudaGetLastError() (0 on success).
// `el`, `er`, `m`, `den` and `p` are (n, h) f32, h <= 16; `fs` is (n, ld)
// with ld >= hf = h * f, f32 or bf16 by `fs_bf16`, hf <= 256; `out` and `u`
// are (n, hf) f32. `u` and `p` are null without aux. The caller zeroes the
// `num_split` rows listed in `split_rows` (int64) in out, den, u and p; the
// kernel writes every element of every other row. `seed` (one int64 on the
// device, its low 32 bits the hash's seed) is given, with `rate` and
// `keep_scale` = f32(1 / (1 - rate)), to the library built for the dropout
// mode, and null to the other; a call to the wrong library returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int stg_flash_gat_fwd(const void* indptr, const void* cols,
                                 const void* el, const void* er,
                                 const void* m, const void* fs, int fs_bf16,
                                 const void* item_row, const void* item_beg,
                                 int num_items, const void* split_rows,
                                 int num_split, void* out, void* den, void* u,
                                 void* p, int h, int f, int ld, float slope,
                                 int chunk, const void* seed, float rate,
                                 float keep_scale, void* stream) {
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
  a.slope = slope;
  a.chunk = chunk;
  a.seed = static_cast<const int64_t*>(seed);
  a.rate = rate;
  a.keep_scale = keep_scale;
  a.stream = static_cast<cudaStream_t>(stream);
  if ((seed != nullptr) != kDropMode) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fs_bf16) {
    launch<__nv_bfloat16>(a);
  } else {
    launch<float>(a);
  }
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
