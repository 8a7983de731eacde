// A probe of K1's first design, for benchmarking/micro/k1_bench.py: its walk
// with the number of edges a warp takes a step and the products as
// template parameters, to time those parts apart on the card. It is not
// part of the port and no path calls it.
//
//   out[d, c] = sum_{e in item} (kW ? w[e] * feats[cols[e], c] : feats[cols[e], c])
//
// over one 128-column tile (f <= 128), one head, f32 sums. The first design
// (stgraph_tpu_torch/csrc/spmm_rowmask.cu before its redesign): one warp a work
// item, 32 (col, w) pairs loaded at once and broadcast by shuffle, a lane
// four columns (8 B of bf16 or 16 B of f32) of each gathered row, one edge
// a step, `#pragma unroll 4`, the bf16 product rounded to bf16 before the
// f32 add. Here kEdges edges a step: 32 / kEdges lanes take an edge, each
// lane kEdges pieces of four columns of it, and the edges' partial sums
// meet by shuffles once per item. kEdges = 1 is the first design's walk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk1_parts.so k1_parts.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

template <typename T>
__device__ __forceinline__ float product(float x, float w) {
  const float p = __fmul_rn(x, w);
  return sizeof(T) == 2 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
}

template <typename T>
__device__ __forceinline__ float stream_weight(float w) {
  return sizeof(T) == 2 ? __bfloat162float(__float2bfloat16_rn(w)) : w;
}

template <typename T, int kEdges, bool kW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k1_probe_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
                const float* __restrict__ w, const T* __restrict__ feats,
                const int32_t* __restrict__ item_row, const int32_t* __restrict__ item_beg,
                float* __restrict__ out, int num_items, int f, int ld, int chunk) {
  constexpr int kLanes = 32 / kEdges;  // lanes an edge
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;
  const int row = item_row[item];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - indptr[row] > chunk;
  const int grp = lane / kLanes, sub = lane % kLanes;
  float acc[kEdges][4] = {};
  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int my_col = 0;
    float my_w = 0.f;
    if (e < end) {
      my_col = cols[e];
      if (kW) my_w = stream_weight<T>(w[e]);
    }
    const int cnt = min(32, end - base);
#pragma unroll 4
    for (int j = 0; j < cnt; j += kEdges) {
      const int jj = j + grp;  // < 32
      const int src = __shfl_sync(kFull, my_col, jj);
      const float wt = kW ? __shfl_sync(kFull, my_w, jj) : 1.f;
      const T* p = feats + static_cast<int64_t>(src) * ld;
#pragma unroll
      for (int r = 0; r < kEdges; ++r) {
        const int c = 4 * sub + 4 * kLanes * r;
        if (jj < cnt && c < f) {
          float v[4];
          load4(p + c, v);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] += kW ? product<T>(v[k], wt) : v[k];
        }
      }
    }
  }
#pragma unroll
  for (int s = kLanes; s < 32; s <<= 1) {
#pragma unroll
    for (int r = 0; r < kEdges; ++r) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] += __shfl_xor_sync(kFull, acc[r][k], s);
    }
  }
  if (grp != 0) return;
  float* o = out + static_cast<int64_t>(row) * f;
#pragma unroll
  for (int r = 0; r < kEdges; ++r) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = 4 * sub + 4 * kLanes * r + k;
      if (c < f) {
        if (split) {
          atomicAdd(o + c, acc[r][k]);
        } else {
          o[c] = acc[r][k];
        }
      }
    }
  }
}

template <typename T, int kEdges>
void launch(bool weighted, const int32_t* indptr, const int32_t* cols, const float* w, const void* feats,
            const int32_t* item_row, const int32_t* item_beg, float* out, int num_items, int f, int ld,
            int chunk, cudaStream_t stream) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const T* t = static_cast<const T*>(feats);
  if (weighted) {
    k1_probe_kernel<T, kEdges, true><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        indptr, cols, w, t, item_row, item_beg, out, num_items, f, ld, chunk);
  } else {
    k1_probe_kernel<T, kEdges, false><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        indptr, cols, w, t, item_row, item_beg, out, num_items, f, ld, chunk);
  }
}

}  // namespace

// `feats` (n, ld), ld % 4 == 0 and 16 B aligned, f <= 128; `w` null for the
// unweighted walk; `edges` 1 or 2. Returns cudaGetLastError().
extern "C" int stg_k1_probe(const void* indptr, const void* cols, const void* w, const void* feats,
                            int feats_bf16, int edges, const void* item_row, const void* item_beg,
                            int num_items, void* out, int f, int ld, int chunk, void* stream) {
  if (f > 128 || ld % 4 != 0 || (edges != 1 && edges != 2)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* cl = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool weighted = wt != nullptr;
  if (feats_bf16) {
    if (edges == 1) {
      launch<__nv_bfloat16, 1>(weighted, ip, cl, wt, feats, ir, ib, o, num_items, f, ld, chunk, s);
    } else {
      launch<__nv_bfloat16, 2>(weighted, ip, cl, wt, feats, ir, ib, o, num_items, f, ld, chunk, s);
    }
  } else if (edges == 1) {
    launch<float, 1>(weighted, ip, cl, wt, feats, ir, ib, o, num_items, f, ld, chunk, s);
  } else {
    launch<float, 2>(weighted, ip, cl, wt, feats, ir, ib, o, num_items, f, ld, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
