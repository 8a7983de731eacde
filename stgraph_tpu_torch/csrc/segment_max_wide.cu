// K5 on Hopper: the wide segment max over a CSR.
//
//   out[d, k] = max_{e in [indptr[d], indptr[d+1])} vals[e, k]
//
// for any width K, f32, with vals an (E, K) plane in CSR order. Empty rows
// give 0, as do rows whose maximum is -inf. Padding slots (positions at or
// past indptr[n]) belong to no row and are never read.
//
// Replaces the TPU kernel segment_pallas._wide_max_kernel
// (stgraph_tpu/ops/segment_pallas.py:466, reached from segment_max_wide
// :620 through _wide_call at pallas_call :597). The composed GAT route
// uses it for the stability max of its softmax past 16 heads
// (stgraph_tpu/ops/attention.py:238), and aggregate(max) for wide values.
//
// What bounds it on an H100: memory. One compare per edge and column; the
// compulsory bytes (indptr, the (E, K) plane once, the output once) are all
// it reads, in CSR order: at the GAT paper's PPI size with K = 32 heads
// (818,716 edges) about 112 MB, 0.034 ms.
//
// What the design does about it:
//   - K1's work items: one warp per destination row, a row of more than
//     `chunk` edges split into several items whose maxima meet by K4's
//     atomic float max in rows the wrapper filled with -inf (a second small
//     kernel then maps -inf to 0 in those rows);
//   - the columns are cut into tiles of 128 (blockIdx.y). Inside a tile of
//     width kt, a lane owns a group of 4 consecutive columns, and the
//     ceil(kt / 4) groups, rounded up to a power of two gp, leave 32 / gp
//     lanes for each group: lane l takes column group l % gp of edge
//     offset l / gp, so a warp reads 32 / gp consecutive edges' rows at once
//     (at K = 32: 8 lanes a row, 4 rows, 512 contiguous bytes a step, every
//     lane busy);
//   - each lane keeps 4 running maxima in registers; after the item's last
//     edge the lanes of a column group meet by shuffles (log2(32 / gp)
//     steps), and the lanes of edge offset 0 store;
//   - 16 B vector loads where K % 4 == 0 and the plane is 16 B aligned,
//     scalar loads otherwise.
//
// A maximum is exact, so the result does not depend on the order of the
// edges or of the atomics: the kernel equals its plain version bit for bit.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_max_wide-<hash>.so \
//        segment_max_wide.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;  // columns of one tile (blockIdx.y)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// Float max by integer atomics: non-negative floats order as ints, negative
// ones in reverse as unsigned ints; -0.0 goes the unsigned way, where it is
// above every negative value.
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_max_wide_kernel(const int32_t* __restrict__ indptr,
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

  float acc[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
  if (active) {
#pragma unroll 4
    for (int e = beg + lane / gp; e < end; e += step) {
      const float* p = vals + static_cast<int64_t>(e) * k + c0 + col;
      if (kVec) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        acc[0] = fmaxf(acc[0], q.x);
        acc[1] = fmaxf(acc[1], q.y);
        acc[2] = fmaxf(acc[2], q.z);
        acc[3] = fmaxf(acc[3], q.w);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (col + kk < kt) acc[kk] = fmaxf(acc[kk], __ldg(p + kk));
        }
      }
    }
  }
  // the lanes of one column group: g, g + gp, g + 2 gp, ...
  for (int s = gp; s < 32; s <<= 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc[kk] = fmaxf(acc[kk], __shfl_xor_sync(kFull, acc[kk], s));
    }
  }
  if (lane < gp && active) {
    float* o = out + static_cast<int64_t>(row) * k + c0 + col;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (col + kk < kt) {
        if (split) {
          atomic_max_float(o + kk, acc[kk]);
        } else {
          o[kk] = acc[kk] == neg_inf() ? 0.f : acc[kk];
        }
      }
    }
  }
}

// Rows of split items: -inf (no value above it arrived) becomes 0.
__global__ void clear_neg_inf_kernel(const int64_t* __restrict__ rows,
                                     int num_rows, int k,
                                     float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(num_rows) * k) return;
  float* o = out + rows[i / k] * k + i % k;
  if (*o == neg_inf()) *o = 0.f;
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success).
// `vals` is the (capacity, k) f32 plane in CSR order. `out` is (n, k) f32,
// with the `num_split` rows listed in `split_rows` (int64) filled with -inf
// by the caller; the kernel writes every element of every other row.
extern "C" int stg_segment_max_wide(const void* indptr, const void* vals,
                                    const void* item_row, const void* item_beg,
                                    int num_items, const void* split_rows,
                                    int num_split, void* out, int k, int chunk,
                                    void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* v = static_cast<const float*>(vals);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (k + kTile - 1) / kTile);
  const dim3 block(kWarpsPerBlock * 32);
  if (k % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0) {
    segment_max_wide_kernel<true><<<grid, block, 0, s>>>(ip, v, ir, ib, o,
                                                         num_items, k, chunk);
  } else {
    segment_max_wide_kernel<false><<<grid, block, 0, s>>>(ip, v, ir, ib, o,
                                                          num_items, k, chunk);
  }
  if (num_split > 0) {
    const int64_t total = static_cast<int64_t>(num_split) * k;
    clear_neg_inf_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
        static_cast<const int64_t*>(split_rows), num_split, k, o);
  }
  return static_cast<int>(cudaGetLastError());
}
