// K7 on Hopper: per-row live count or weight sum of a flat row-id edge store.
//
//   den[r] = sum_{slots e with rows[e] == r} w[e]      (w = 1 when null)
//
// Replaces the TPU kernel dyn_spmm._rowid_denom_kernel
// (stgraph_tpu/ops/dyn_spmm.py:382, reached from dyn_degree at pallas_call
// :483), which feeds the per-timestep GCN norms of the lazy dynamic store
// (lazy_norm, once in every GCNConv on a store pair).
//
// The store is "live-sorted": slots whose row id is below n are in
// nondecreasing row order; sentinel slots (row id n) may sit anywhere. The
// store changes every timestep on the device, so the kernel, like K6, finds
// its work from the device arrays alone.
//
// What bounds it on an H100: memory, and at the shapes it runs at, launch
// latency. It reads rows and w once and writes den once: 22 MB, about 7 us,
// at 2.2M slots and 1.1M rows.
//
// What the design does about it (K6's edge-chunk design): each thread takes
// a fixed run of `chunk` slots, sums runs of equal row id in a register and
// flushes each run with one atomicAdd into den, which the wrapper zeroed. A
// hub row spread over many chunks meets there; sentinel slots are skipped by
// their row id. No metadata, one launch. Counts (integers below 2^24) are
// exact in any order of the adds.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/librowid_denom-<hash>.so rowid_denom.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <bool kWeighted>
__global__ void __launch_bounds__(kThreads)
rowid_denom_kernel(const int32_t* __restrict__ rows, const float* __restrict__ w,
                   float* __restrict__ den, int64_t cap, int n, int chunk) {
  const int64_t beg = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * chunk;
  if (beg >= cap) return;
  const int64_t end = beg + chunk < cap ? beg + chunk : cap;
  int cur = -1;  // row id of the run in acc, -1 before the first
  float acc = 0.f;
  for (int64_t e = beg; e < end; ++e) {
    const int r = rows[e];
    if (r < 0 || r >= n) continue;  // a sentinel
    if (r != cur) {
      if (cur >= 0) atomicAdd(den + cur, acc);
      cur = r;
      acc = 0.f;
    }
    acc += kWeighted ? w[e] : 1.f;
  }
  if (cur >= 0) atomicAdd(den + cur, acc);
}

}  // namespace

// Launches K7 on `stream` and returns cudaGetLastError() (0 on success).
// `rows` (cap,) int32, `w` (cap,) f32 or null (count the slots whose row id
// is below n), `den` (n,) f32 zeroed by the caller; each thread takes
// `chunk` slots.
extern "C" int stg_rowid_denom(const void* rows, const void* w, void* den, int64_t cap,
                               int n, int chunk, void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* wt = static_cast<const float*>(w);
  auto* d = static_cast<float*>(den);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t threads = (cap + chunk - 1) / chunk;
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (blocks > 0) {
    if (wt != nullptr) {
      rowid_denom_kernel<true><<<blocks, kThreads, 0, st>>>(r, wt, d, cap, n, chunk);
    } else {
      rowid_denom_kernel<false><<<blocks, kThreads, 0, st>>>(r, wt, d, cap, n, chunk);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
