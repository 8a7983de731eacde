// Probes of K3's first design, for benchmarking/micro/k3_bench.py: the
// kernel with its parts apart, to time them alone on the card. It is not
// part of the port and no path calls it.
//
// K3's first design (stgraph_tpu_torch/csrc/segment_sum_narrow.cu before its
// redesign): one warp a work item of at most 1024 edges (k1_work_items); a
// warp loads its item's row, then the item's first edge and the row's
// bounds, before any value; each lane takes one edge an iteration with K
// scalar loads at a K * 4 B stride; the warp's sums meet by 5 shuffles a
// column, lane k stores column k, and the items of a split row meet by
// atomicAdd in rows the wrapper zeroed (index_fill_, a launch of its own):
//
//   kPhase 0: the whole kernel (a check of the copy);
//   kPhase 1: the item chain alone: item row, first edge and row bounds
//             loaded as the first design loads them, no value read (each
//             lane's sums are its edge count), the meeting and the stores;
//   kPhase 2: the value stream alone: each item's (row, first edge, end,
//             split) at hand in one int4, the values read and summed as the
//             first design reads them, the meeting and the stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk3_parts.so k3_parts.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

template <int kMaxK, int kPhase>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k3_probe_kernel(const int32_t* __restrict__ indptr, const float* __restrict__ vals,
                const int32_t* __restrict__ item_row, const int32_t* __restrict__ item_beg,
                const int4* __restrict__ bounds, float* __restrict__ out, int num_items, int k, int chunk) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;  // warp-uniform
  int row, beg, end;
  bool split;
  if (kPhase == 2) {
    const int4 b = __ldg(bounds + item);
    row = b.x;
    beg = b.y;
    end = b.z;
    split = b.w != 0;
  } else {
    row = item_row[item];
    const int row_beg = indptr[row];
    const int row_end = indptr[row + 1];
    beg = item_beg[item];
    end = min(beg + chunk, row_end);
    split = row_end - row_beg > chunk;
  }

  float acc[kMaxK];
#pragma unroll
  for (int kk = 0; kk < kMaxK; ++kk) acc[kk] = 0.f;
  for (int e = beg + lane; e < end; e += 32) {
    if (kPhase == 1) {
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) acc[kk] += 1.f;
    } else {
      const float* p = vals + static_cast<int64_t>(e) * k;
#pragma unroll
      for (int kk = 0; kk < kMaxK; ++kk) {
        if (kk < k) acc[kk] += __ldg(p + kk);
      }
    }
  }
  float mine = 0.f;
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
void launch(int phase, const int32_t* indptr, const float* vals, const int32_t* ir, const int32_t* ib,
            const int4* bounds, float* out, int num_items, int k, int chunk, cudaStream_t s) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (phase == 0) {
    k3_probe_kernel<kMaxK, 0><<<grid, kWarpsPerBlock * 32, 0, s>>>(indptr, vals, ir, ib, bounds, out, num_items, k,
                                                                   chunk);
  } else if (phase == 1) {
    k3_probe_kernel<kMaxK, 1><<<grid, kWarpsPerBlock * 32, 0, s>>>(indptr, vals, ir, ib, bounds, out, num_items, k,
                                                                   chunk);
  } else {
    k3_probe_kernel<kMaxK, 2><<<grid, kWarpsPerBlock * 32, 0, s>>>(indptr, vals, ir, ib, bounds, out, num_items, k,
                                                                   chunk);
  }
}

}  // namespace

// The probe `phase` (0-2, above) of K3's first design on `stream`, on the
// first design's arguments plus `bounds` (num_items int4: row, first edge,
// end, split; read by phase 2 only). Returns cudaGetLastError().
extern "C" int stg_k3_probe(const void* indptr, const void* vals, const void* item_row, const void* item_beg,
                            const void* bounds, int num_items, void* out, int k, int chunk, int phase,
                            void* stream) {
  if (phase < 0 || phase > 2 || k < 1 || k > 16) return static_cast<int>(cudaErrorInvalidValue);
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* v = static_cast<const float*>(vals);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  const auto* b = static_cast<const int4*>(bounds);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 4) {
    launch<4>(phase, ip, v, ir, ib, b, o, num_items, k, chunk, s);
  } else if (k <= 8) {
    launch<8>(phase, ip, v, ir, ib, b, o, num_items, k, chunk, s);
  } else {
    launch<16>(phase, ip, v, ir, ib, b, o, num_items, k, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
