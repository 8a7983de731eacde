// K1's no-gather mode on Hopper: the wide segment sum over a CSR.
//
//   out[d, k] = sum_{e in [indptr[d], indptr[d+1])} vals[e, k]
//
// for any width K, f32 sums, with vals an (E, K) plane in CSR order. Empty
// rows give 0. Padding slots (positions at or past indptr[n]) belong to no
// row and are never read.
//
// Replaces the TPU kernel segment_pallas._spmm_rowmask_kernel run without
// weights on the plane itself (stgraph_tpu/ops/segment_pallas.py:761,
// reached from segment_sum_wide :661 at pallas_call :710). The composed GAT
// route uses it past 16 heads for the softmax denominator and, in backward,
// for d el (transpose CSR) and d er (forward CSR); aggregate(sum, mean)
// for wide values.
//
// What bounds it on an H100: memory. One add per edge and column; the
// compulsory bytes (indptr, the (E, K) plane once, the output once) are all
// it reads, in CSR order: at the GAT paper's PPI size with K = 32 heads
// about 112 MB, 0.034 ms.
//
// What the design does about it: K5's (csrc/segment_max_wide.cu), with a
// sum in place of the max. K1's work items, one warp a destination row,
// hub rows split into items whose sums meet by atomicAdd in rows the
// wrapper zeroed (so the last bits of a hub row's sum vary from run to
// run); tiles of 128 columns; lanes as (edge offset, group of 4 columns)
// pairs, 32 / gp consecutive edges a step (at K = 32: 4 rows, 512
// contiguous bytes, every lane busy), the edge lanes met by shuffles.
//
// Rounding matches the TPU kernel: with a bf16 stream (the wrapper's rule,
// capacity >= 200,000 and f32 values, segment_pallas.py:682-686) each value
// is rounded to bf16 and the sum is taken in f32. The kernel rounds each
// f32 value as it loads it, so no bf16 copy of the plane is written; with
// an f32 stream every step is f32. Only the order of the f32 sums differs
// from the plain version.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_sum_wide-<hash>.so \
//        segment_sum_wide.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;  // columns of one tile (blockIdx.y)
constexpr unsigned kFull = 0xffffffffu;

template <bool kBf16>
__device__ __forceinline__ float stream_value(float x) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

template <bool kVec, bool kBf16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_wide_kernel(const int32_t* __restrict__ indptr,
                        const float* __restrict__ vals,
                        const int32_t* __restrict__ item_row,
                        const int32_t* __restrict__ item_beg,
                        float* __restrict__ out, int num_items, int k,
                        int chunk) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;  // warp-uniform
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;

  const int c0 = blockIdx.y * kTile;
  const int kt = min(kTile, k - c0);  // this tile's width
  const int groups = (kt + 3) >> 2;
  int gp = 1;
  while (gp < groups) gp <<= 1;  // <= 32
  const int step = 32 / gp;      // edges a warp reads at once
  const int g = lane & (gp - 1);
  const int col = 4 * g;  // first column of this lane's group, in the tile
  const bool active = col < kt;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (active) {
#pragma unroll 4
    for (int e = beg + lane / gp; e < end; e += step) {
      const float* p = vals + static_cast<int64_t>(e) * k + c0 + col;
      if (kVec) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        acc[0] += stream_value<kBf16>(q.x);
        acc[1] += stream_value<kBf16>(q.y);
        acc[2] += stream_value<kBf16>(q.z);
        acc[3] += stream_value<kBf16>(q.w);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (col + kk < kt) acc[kk] += stream_value<kBf16>(__ldg(p + kk));
        }
      }
    }
  }
  // the lanes of one column group: g, g + gp, g + 2 gp, ...
  for (int s = gp; s < 32; s <<= 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc[kk] += __shfl_xor_sync(kFull, acc[kk], s);
  }
  if (lane < gp && active) {
    float* o = out + static_cast<int64_t>(row) * k + c0 + col;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (col + kk < kt) {
        if (split) {
          atomicAdd(o + kk, acc[kk]);
        } else {
          o[kk] = acc[kk];
        }
      }
    }
  }
}

template <bool kBf16>
void launch(const int32_t* indptr, const float* vals, const int32_t* item_row,
            const int32_t* item_beg, float* out, int num_items, int k,
            int chunk, cudaStream_t stream) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (k + kTile - 1) / kTile);
  const dim3 block(kWarpsPerBlock * 32);
  if (k % 4 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0) {
    segment_sum_wide_kernel<true, kBf16><<<grid, block, 0, stream>>>(
        indptr, vals, item_row, item_beg, out, num_items, k, chunk);
  } else {
    segment_sum_wide_kernel<false, kBf16><<<grid, block, 0, stream>>>(
        indptr, vals, item_row, item_beg, out, num_items, k, chunk);
  }
}

}  // namespace

// Launches the no-gather mode on `stream` and returns cudaGetLastError()
// (0 on success). `vals` is the (capacity, k) f32 plane in CSR order, each
// value rounded to bf16 as it is read when `round_bf16`; `out` is (n, k)
// f32 with the rows of split work items zeroed by the caller.
extern "C" int stg_segment_sum_wide(const void* indptr, const void* vals,
                                    int round_bf16, const void* item_row,
                                    const void* item_beg, int num_items,
                                    void* out, int k, int chunk, void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* v = static_cast<const float*>(vals);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (round_bf16) {
    launch<true>(ip, v, ir, ib, o, num_items, k, chunk, s);
  } else {
    launch<false>(ip, v, ir, ib, o, num_items, k, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
