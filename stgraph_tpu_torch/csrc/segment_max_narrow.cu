// K4 on Hopper: the narrow segment max over a CSR.
//
//   out[d, k] = max_{e in [indptr[d], indptr[d+1])} vals[index[e], k]
//
// for k < K, K <= 16 (MAX_NARROW_K), f32. Without `index` the values are read
// per edge, vals[e, k] (an (E, K) plane in CSR order). Empty rows give 0, as
// do rows whose maximum is -inf. Padding slots (positions at or past
// indptr[n]) belong to no row and are never read.
//
// Replaces the TPU kernel segment_pallas._narrow_max_kernel
// (stgraph_tpu/ops/segment_pallas.py:235, reached from segment_max_narrow at
// pallas_call :427). flash-GAT's forward uses it for the stability max of
// its softmax, max_e el[src_e, h], with vals = el (N, H) and index = cols,
// so no (E, H) plane is built (3.96 GB at ogbn-products size, H = 8).
//
// What bounds it on an H100: memory. It does one compare per edge and
// column, while the gather of el[cols[e]] reads a 32 B sector per edge
// (H = 8) spread over the whole table. The compulsory bytes (indptr, cols,
// the table once, the output once) give a bound of about 0.2 ms at
// ogbn-products size; the gathered sectors are about 4 GB.
//
// What the design does about it:
//   - one warp per destination row (a "work item", the same items as K1),
//     lanes across the edges: 32 consecutive cols[e] are one coalesced
//     load, and each lane keeps K running maxima in registers, so the
//     per-edge work is K loads and K compares with no cross-lane traffic;
//   - the K maxima are combined across the warp once per item (5 shuffles
//     each), and lane k stores column k;
//   - a row with more than `chunk` edges is split into several items whose
//     maxima meet by an atomic float max (an int max for non-negative
//     values, an unsigned min for negative ones) in rows the wrapper filled
//     with -inf; a second small kernel then maps -inf to 0 in those rows.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_max_narrow-<hash>.so \
//        segment_max_narrow.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
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

template <int kMaxK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_max_narrow_kernel(const int32_t* __restrict__ indptr,
                          const int32_t* __restrict__ index,
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

  float acc[kMaxK];
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) acc[kk] = neg_inf();
  for (int e = beg + lane; e < end; e += 32) {
    const int64_t r = index != nullptr ? static_cast<int64_t>(index[e]) : e;
    const float* p = vals + r * k;
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      if (kk < k) acc[kk] = fmaxf(acc[kk], __ldg(p + kk));
    }
  }
  float mine = neg_inf();  // the maximum of column `lane`
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

// Rows of split items: -inf (no value above it arrived) becomes 0.
__global__ void clear_neg_inf_kernel(const int64_t* __restrict__ rows,
                                     int num_rows, int k,
                                     float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_rows * k) return;
  float* o = out + rows[i / k] * k + i % k;
  if (*o == neg_inf()) *o = 0.f;
}

template <int kMaxK>
void launch(const int32_t* indptr, const int32_t* index, const float* vals,
            const int32_t* item_row, const int32_t* item_beg, float* out,
            int num_items, int k, int chunk, cudaStream_t stream) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_max_narrow_kernel<kMaxK><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      indptr, index, vals, item_row, item_beg, out, num_items, k, chunk);
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success).
// `vals` is (rows, k) f32 with k <= 16: per edge in CSR order when `index`
// is null, else a node table read at index[e]. `out` is (n, k) f32, with the
// `num_split` rows listed in `split_rows` (int64) filled with -inf by the
// caller; the kernel writes every element of every other row.
extern "C" int stg_segment_max_narrow(const void* indptr, const void* index,
                                      const void* vals, const void* item_row,
                                      const void* item_beg, int num_items,
                                      const void* split_rows, int num_split,
                                      void* out, int k, int chunk,
                                      void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(index);
  const auto* v = static_cast<const float*>(vals);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 1) {
    launch<1>(ip, ix, v, ir, ib, o, num_items, k, chunk, s);
  } else if (k <= 2) {
    launch<2>(ip, ix, v, ir, ib, o, num_items, k, chunk, s);
  } else if (k <= 4) {
    launch<4>(ip, ix, v, ir, ib, o, num_items, k, chunk, s);
  } else if (k <= 8) {
    launch<8>(ip, ix, v, ir, ib, o, num_items, k, chunk, s);
  } else {
    launch<16>(ip, ix, v, ir, ib, o, num_items, k, chunk, s);
  }
  if (num_split > 0) {
    const int total = num_split * k;
    clear_neg_inf_kernel<<<(total + 255) / 256, 256, 0, s>>>(
        static_cast<const int64_t*>(split_rows), num_split, k, o);
  }
  return static_cast<int>(cudaGetLastError());
}
