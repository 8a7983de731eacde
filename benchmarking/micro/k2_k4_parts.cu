// Probes of K2's and K4's first design, for benchmarking/micro/k2_k4_bench.py:
// each kernel with its parts apart, to time them alone on the card. It is
// not part of the port and no path calls it.
//
// K2's first design (stgraph_tpu_torch/csrc/spmm_sddmm_rowmask.cu before its
// redesign): one warp a work item of at most 1024 edges, lanes across the
// row's columns (4 a lane: one 8 B bf16 or 16 B f32 load), one edge a warp
// step: the edge's column and weight broadcast by shuffle, its g row
// gathered, dh's product added, dw's partial dot formed and summed over the
// warp by five __shfl_xor_sync (one head) or log2(F / 4) (heads), then
// stored. Only its vector tiles are here (ld % 4 == 0, an aligned table):
//
//   kPhase 0: the whole kernel (as the first design; a check of the copy);
//   kPhase 1: the walk alone: (col, w) broadcast, g gathered, dh summed
//             from the gathered values unweighted; no dw product, shuffle or
//             store (dw untouched);
//   kPhase 2: the products alone: no row gathered (the values made from
//             the column id), both products (dh's w g and dw's fs g,
//             rounded as the stream rounds them) and dh's sum, dw's partial
//             kept per lane without the shuffles, each lane storing its sum;
//   kPhase 3: the dw reduction alone: no row gathered, no product, a value
//             made from the column id summed over the warp by the first
//             design's shuffles and stored as dw; dh 0.
//
// K4's first design (csrc/segment_max_narrow.cu before its redesign): one
// warp a work item of at most 1024 edges, lanes across the edges, one edge
// a lane an iteration with K dependent scalar loads of its row, the warp's
// maxima met by 5 shuffles a column, split rows by atomic max and a second
// kernel mapping -inf to 0 (not here):
//
//   kPhase 0: the whole kernel (split rows left at their atomic maximum);
//   kPhase 1: no row gathered: the index stream alone, the maximum taken of
//             the index ids as floats;
//   kPhase 2: the items alone: no edge read, each item's metadata, the
//             warp's meeting and its stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk2_k4_parts.so k2_k4_parts.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) { return __uint_as_float(bits16 << 16); }

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_bits_to_float(q.x & 0xffffu);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = bf16_bits_to_float(q.y & 0xffffu);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float round_to_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

template <typename T>
__device__ __forceinline__ float stream_value(float x) {
  return sizeof(T) == 2 ? round_to_bf16(x) : x;
}

template <typename T>
__device__ __forceinline__ float product(float a, float b) {
  return sizeof(T) == 2 ? round_to_bf16(__fmul_rn(a, b)) : __fmul_rn(a, b);
}

constexpr int kOneHead = 0;
constexpr int kLaneGroups = 1;
constexpr int kInLane = 2;

template <typename T, int kMode, int kPhase>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k2_probe_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols, const float* __restrict__ w,
                const T* __restrict__ g, const float* __restrict__ fs, const int32_t* __restrict__ item_row,
                const int32_t* __restrict__ item_beg, float* __restrict__ dh, float* __restrict__ dw,
                int num_items, int f, int ld, int heads, int head_f, int chunk) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  const float* fs_row = fs + static_cast<int64_t>(row) * f;
  float* dh_row = dh + static_cast<int64_t>(row) * f;
  const int group = kMode == kLaneGroups ? head_f / 4 : 1;

  for (int c0 = 0; c0 < f; c0 += kTile) {
    float x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + lane * 4 + k;
      x[k] = c < f ? stream_value<T>(__ldg(fs_row + c)) : 0.f;
    }
    const int head0 = (c0 + lane * 4) / head_f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      int my_col = 0;
      float my_w = 0.f;
      if (e < end) {
        my_col = cols[e];
        if (kMode == kOneHead) my_w = stream_value<T>(w[e]);
      }
      float my_dw = 0.f;
      const int cnt = min(32, end - base);
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int dst = __shfl_sync(kFull, my_col, j);
        const int64_t ej = base + j;
        float wt[4];
        if (kMode == kOneHead) {
          wt[0] = wt[1] = wt[2] = wt[3] = __shfl_sync(kFull, my_w, j);
        } else if (kMode == kLaneGroups) {
          wt[0] = wt[1] = wt[2] = wt[3] = stream_value<T>(__ldg(w + ej * heads + head0));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) wt[k] = stream_value<T>(__ldg(w + ej * heads + head0 + k / head_f));
        }
        float v[4];
        if (kPhase == 0 || kPhase == 1) {
          const T* p = g + static_cast<int64_t>(dst) * ld + c0;
          const int c = lane * 4;
          if (c0 + c < ld) {
            load4(p + c, v);
          } else {
            v[0] = v[1] = v[2] = v[3] = 0.f;
          }
        } else {  // no gather: values made from the column id
#pragma unroll
          for (int k = 0; k < 4; ++k) v[k] = stream_value<T>(static_cast<float>(dst + k) * 1e-6f);
        }
        if (kPhase == 1) {
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[k] += v[k];
          continue;
        }
        float part[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (kPhase != 3) acc[k] += product<T>(v[k], wt[k]);
          part[k] = kPhase == 3 ? v[k] : product<T>(x[k], v[k]);
        }
        if (kPhase == 2) {
          my_dw += (part[0] + part[1]) + (part[2] + part[3]);
          continue;
        }
        if (kMode == kInLane) {
          float* d = dw + ej * heads + head0;
          if (head_f == 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) d[k] = part[k];
          } else {
            d[0] = part[0] + part[1];
            d[1] = part[2] + part[3];
          }
        } else {
          float dot = (part[0] + part[1]) + (part[2] + part[3]);
          for (int s = (kMode == kOneHead ? 32 : group) >> 1; s > 0; s >>= 1) {
            dot += __shfl_xor_sync(kFull, dot, s);
          }
          if (kMode == kOneHead) {
            if (lane == j) my_dw = dot;
          } else if ((lane & (group - 1)) == 0) {
            dw[ej * heads + head0] = dot;
          }
        }
      }
      if (kPhase == 1) continue;
      if (kPhase == 2) {
        if (e < end) dw[kMode == kOneHead ? e : e * heads] = my_dw;
        continue;
      }
      if (kMode == kOneHead && e < end) dw[e] = c0 == 0 ? my_dw : dw[e] + my_dw;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + lane * 4 + k;
      if (c < f) {
        if (split) {
          atomicAdd(dh_row + c, acc[k]);
        } else {
          dh_row[c] = acc[k];
        }
      }
    }
  }
}

template <typename T, int kMode>
void k2_launch(int phase, dim3 grid, cudaStream_t s, const int32_t* indptr, const int32_t* cols, const float* w,
               const T* g, const float* fs, const int32_t* ir, const int32_t* ib, float* dh, float* dw,
               int num_items, int f, int ld, int heads, int chunk) {
  const int hf = f / heads;
  const int threads = kWarpsPerBlock * 32;
  if (phase == 0) {
    k2_probe_kernel<T, kMode, 0><<<grid, threads, 0, s>>>(indptr, cols, w, g, fs, ir, ib, dh, dw, num_items, f, ld,
                                                          heads, hf, chunk);
  } else if (phase == 1) {
    k2_probe_kernel<T, kMode, 1><<<grid, threads, 0, s>>>(indptr, cols, w, g, fs, ir, ib, dh, dw, num_items, f, ld,
                                                          heads, hf, chunk);
  } else if (phase == 2) {
    k2_probe_kernel<T, kMode, 2><<<grid, threads, 0, s>>>(indptr, cols, w, g, fs, ir, ib, dh, dw, num_items, f, ld,
                                                          heads, hf, chunk);
  } else {
    k2_probe_kernel<T, kMode, 3><<<grid, threads, 0, s>>>(indptr, cols, w, g, fs, ir, ib, dh, dw, num_items, f, ld,
                                                          heads, hf, chunk);
  }
}

template <typename T>
int k2_dispatch(int phase, const int32_t* indptr, const int32_t* cols, const float* w, const T* g,
                const float* fs, const int32_t* ir, const int32_t* ib, int num_items, float* dh, float* dw, int f,
                int ld, int heads, int chunk, cudaStream_t s) {
  if (ld % 4 != 0 || reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) != 0 || f % heads != 0) return -1;
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const int head_f = f / heads;
  if (heads == 1) {
    k2_launch<T, kOneHead>(phase, grid, s, indptr, cols, w, g, fs, ir, ib, dh, dw, num_items, f, ld, heads, chunk);
  } else if (kTile % head_f == 0 && f % kTile == 0 && head_f >= 4) {
    k2_launch<T, kLaneGroups>(phase, grid, s, indptr, cols, w, g, fs, ir, ib, dh, dw, num_items, f, ld, heads,
                              chunk);
  } else if (kTile % head_f == 0 && f % kTile == 0) {
    k2_launch<T, kInLane>(phase, grid, s, indptr, cols, w, g, fs, ir, ib, dh, dw, num_items, f, ld, heads, chunk);
  } else {
    return -1;
  }
  return 0;
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <int kMaxK, int kPhase>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k4_probe_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ index,
                const float* __restrict__ vals, const int32_t* __restrict__ item_row,
                const int32_t* __restrict__ item_beg, float* __restrict__ out, int num_items, int k, int chunk) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  float acc[kMaxK];
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) acc[kk] = neg_inf();
  if (kPhase != 2) {
    for (int e = beg + lane; e < end; e += 32) {
      const int64_t r = index != nullptr ? static_cast<int64_t>(index[e]) : e;
      if (kPhase == 1) {
        acc[0] = fmaxf(acc[0], static_cast<float>(r));
        continue;
      }
      const float* p = vals + r * k;
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) acc[kk] = fmaxf(acc[kk], __ldg(p + kk));
      }
    }
  }
  float mine = neg_inf();
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) {
    float v = acc[kk];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, s));
    if (lane == kk) mine = v;
  }
  if (lane < k) {
    float* o = out + static_cast<int64_t>(row) * k + lane;
    if (split) {
      atomic_max_float(o, mine);
    } else {
      *o = mine == neg_inf() ? 0.f : mine;
    }
  }
}

template <int kMaxK>
void k4_launch(int phase, dim3 grid, cudaStream_t s, const int32_t* indptr, const int32_t* index, const float* vals,
               const int32_t* ir, const int32_t* ib, float* out, int num_items, int k, int chunk) {
  if (phase == 0) {
    k4_probe_kernel<kMaxK, 0><<<grid, kWarpsPerBlock * 32, 0, s>>>(indptr, index, vals, ir, ib, out, num_items, k,
                                                                   chunk);
  } else if (phase == 1) {
    k4_probe_kernel<kMaxK, 1><<<grid, kWarpsPerBlock * 32, 0, s>>>(indptr, index, vals, ir, ib, out, num_items, k,
                                                                   chunk);
  } else {
    k4_probe_kernel<kMaxK, 2><<<grid, kWarpsPerBlock * 32, 0, s>>>(indptr, index, vals, ir, ib, out, num_items, k,
                                                                   chunk);
  }
}

}  // namespace

// K2's first design with its parts apart (kPhase above), on `stream`: the
// first design's C entry and its contract, with `phase` last but the stream.
extern "C" int stg_k2_probe(const void* indptr, const void* cols, const void* w, const void* g, int g_bf16,
                            const void* fs, const void* item_row, const void* item_beg, int num_items, void* dh,
                            void* dw, int f, int ld, int heads, int chunk, int phase, void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* cl = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* x = static_cast<const float*>(fs);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(dh);
  auto* d = static_cast<float*>(dw);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc = g_bf16 ? k2_dispatch<__nv_bfloat16>(phase, ip, cl, wt, static_cast<const __nv_bfloat16*>(g), x, ir,
                                                     ib, num_items, o, d, f, ld, heads, chunk, s)
                        : k2_dispatch<float>(phase, ip, cl, wt, static_cast<const float*>(g), x, ir, ib, num_items,
                                             o, d, f, ld, heads, chunk, s);
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// K4's first design with its parts apart (kPhase above), on `stream`; split
// rows are not finished (no -inf to 0 pass).
extern "C" int stg_k4_probe(const void* indptr, const void* index, const void* vals, const void* item_row,
                            const void* item_beg, int num_items, void* out, int k, int chunk, int phase,
                            void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(index);
  const auto* v = static_cast<const float*>(vals);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (k <= 1) {
    k4_launch<1>(phase, grid, s, ip, ix, v, ir, ib, o, num_items, k, chunk);
  } else if (k <= 8) {
    k4_launch<8>(phase, grid, s, ip, ix, v, ir, ib, o, num_items, k, chunk);
  } else {
    k4_launch<16>(phase, grid, s, ip, ix, v, ir, ib, o, num_items, k, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
