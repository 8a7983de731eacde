// K3 on Hopper: the narrow segment sum over a CSR.
//
//   out[d, k] = sum_{e in [indptr[d], indptr[d+1])} vals[e, k]
//
// for k < K, K <= 16 (MAX_NARROW_K), f32, with vals an (E, K) plane in CSR
// order. Empty rows give 0. Padding slots (positions at or past indptr[n])
// belong to no row and are never read.
//
// Replaces the TPU kernel segment_pallas._narrow_sum_kernel
// (stgraph_tpu/ops/segment_pallas.py:155, reached from segment_sum_narrow at
// pallas_call :351). The composed GAT route uses it for the softmax
// denominator (per destination, on the forward CSR) and, in backward, for
// d er (forward CSR) and d el (transpose CSR).
//
// What bounds it on an H100: memory. One add per edge and column; the
// compulsory bytes (indptr, the (E, K) plane once, the output once) give
// about 0.6 ms at ogbn-products size with K = 4, and the plane is read in
// CSR order, so every byte read is a compulsory one.
//
// What the design does about it (K4's, with a sum in place of the max):
//   - one warp per destination row (a "work item", the same items as K1),
//     lanes across the edges: each lane keeps K running sums in registers,
//     so the per-edge work is K loads and K adds with no cross-lane traffic;
//   - the K sums are combined across the warp once per item (5 shuffles
//     each), and lane k stores column k;
//   - a row with more than `chunk` edges is split into several items whose
//     sums meet by atomicAdd in rows the wrapper zeroed, so a hub (about
//     10^6 in-edges on ogbn-products) does not leave one warp running long
//     after the rest. The order of those atomics, and so the last bits of a
//     hub row's sum, varies from run to run.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_sum_narrow-<hash>.so \
//        segment_sum_narrow.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int kMaxK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_narrow_kernel(const int32_t* __restrict__ indptr,
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
  for (int kk = 0; kk < kMaxK; ++kk) acc[kk] = 0.f;
  for (int e = beg + lane; e < end; e += 32) {
    const float* p = vals + static_cast<int64_t>(e) * k;
#pragma unroll
    for (int kk = 0; kk < kMaxK; ++kk) {
      if (kk < k) acc[kk] += __ldg(p + kk);
    }
  }
  float mine = 0.f;  // the sum of column `lane`
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) {
    float v = acc[kk];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
    if (lane == kk) mine = v;
  }
  if (lane < k) {
    float* o = out + static_cast<int64_t>(row) * k + lane;
    if (split) {
      atomicAdd(o, mine);
    } else {
      *o = mine;
    }
  }
}

template <int kMaxK>
void launch(const int32_t* indptr, const float* vals, const int32_t* item_row,
            const int32_t* item_beg, float* out, int num_items, int k,
            int chunk, cudaStream_t stream) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_sum_narrow_kernel<kMaxK><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      indptr, vals, item_row, item_beg, out, num_items, k, chunk);
}

}  // namespace

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success).
// `vals` is (E, k) f32 in CSR order with k <= 16. `out` is (n, k) f32, with
// the rows of split work items zeroed by the caller; the kernel writes every
// element of every other row.
extern "C" int stg_segment_sum_narrow(const void* indptr, const void* vals,
                                      const void* item_row,
                                      const void* item_beg, int num_items,
                                      void* out, int k, int chunk,
                                      void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* v = static_cast<const float*>(vals);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 1) {
    launch<1>(ip, v, ir, ib, o, num_items, k, chunk, s);
  } else if (k <= 2) {
    launch<2>(ip, v, ir, ib, o, num_items, k, chunk, s);
  } else if (k <= 4) {
    launch<4>(ip, v, ir, ib, o, num_items, k, chunk, s);
  } else if (k <= 8) {
    launch<8>(ip, v, ir, ib, o, num_items, k, chunk, s);
  } else {
    launch<16>(ip, v, ir, ib, o, num_items, k, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
