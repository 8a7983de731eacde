// K6 on Hopper: SpMM over a flat row-id edge store, for one head.
//
//   out[r, :] = sum_{slots e with rows[e] == r} w[e] * feats[cols[e], :]
//
// Replaces the TPU kernel segment_pallas._spmm_rowid_kernel
// (stgraph_tpu/ops/segment_pallas.py:1673, reached from spmm_rowid_traced at
// pallas_call :1909) on the aggregation of the lazy dynamic store: every
// lazy_spmm runs it on the forward store and, in backward, on the source-keyed
// twin store.
//
// The store is "live-sorted": slots whose row id is below n are in
// nondecreasing row order; sentinel slots (row id n) may sit anywhere;
// tombstoned slots keep their row id and carry w = 0. The store changes every
// timestep on the device, so no host-built work list (K1's) can serve: the
// kernel finds its work from the device arrays alone.
//
// What bounds it on an H100: memory. Two operations per gathered element; the
// compulsory bytes (rows, cols, w, the f32 table once, the f32 output once)
// give about 0.34 ms at the wiki-talk shape (N = 1.1M, 2.2M slots, F = 128),
// and the gathered rows (one per live slot) are about twice the table.
//
// What the design does about it (the edge-chunk design):
//   - a group of kGroup lanes (kGroup = the smallest power of two with
//     4 * kGroup >= F, at most 32) takes a fixed run of `chunk` slots, lanes
//     across the features, 4 columns a lane (one 16 B load where aligned);
//   - the group loads kGroup slots' (row, col, w) at once and broadcasts them
//     with shuffles, then gathers up to kUnroll feature rows before it adds
//     any, so several row reads are in flight per group;
//   - it sums runs of equal row id in registers and flushes a run with one
//     atomicAdd per column into the output, which the wrapper zeroed: a hub
//     row spread over many chunks meets there, and a row wholly inside a
//     chunk costs one add per column;
//   - sentinel, tombstoned and padding slots (row id >= n or w == 0) are
//     skipped before the gather, so a tombstone adds exactly nothing and
//     costs no feature read;
//   - the gather happens inside the kernel (the TPU kernel needed an XLA
//     pre-gather into a (cap, F) plane).
//
// The stream is f32 throughout (lazy_spmm casts its input to f32), the sums
// are f32; only their order differs from the plain version's.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libspmm_rowid-<hash>.so spmm_rowid.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int kGroup, bool kVec, bool kWeighted>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_rowid_kernel(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ cols,
                  const float* __restrict__ w,
                  const float* __restrict__ feats,
                  float* __restrict__ out, int64_t cap, int n, int f,
                  int chunk) {
  constexpr int kUnroll = kGroup < 8 ? kGroup : 8;
  constexpr int kCols = 4 * kGroup;  // columns a group covers per pass
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int group_in_warp = lane / kGroup;
  const unsigned gmask =
      kGroup == 32 ? 0xffffffffu
                   : ((1u << (kGroup & 31)) - 1u) << (group_in_warp * kGroup);
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) *
          (32 / kGroup) +
      group_in_warp;
  const int64_t beg = group * chunk;
  if (beg >= cap) return;  // uniform over the group
  const int64_t end = beg + chunk < cap ? beg + chunk : cap;
  const int c0 = blockIdx.y * kCols;

  // this lane's columns within the tile
  int cidx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) cidx[k] = kVec ? sub * 4 + k : k * kGroup + sub;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cur = -1;  // row id of the run in acc, -1 before the first

  auto flush = [&]() {
    if (cur < 0) return;
    float* o = out + static_cast<int64_t>(cur) * f + c0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + cidx[k] < f) atomicAdd(o + cidx[k], acc[k]);
      acc[k] = 0.f;
    }
  };

  for (int64_t base = beg; base < end; base += kGroup) {
    const int64_t e = base + sub;
    int my_row = -1;
    int my_col = 0;
    float my_w = 0.f;
    if (e < end) {
      const int r = rows[e];
      my_w = kWeighted ? w[e] : 1.f;
      my_col = cols[e];
      if (r < n && my_w != 0.f) my_row = r;  // skip sentinels and tombstones
    }
    const int cnt = static_cast<int>(end - base < kGroup ? end - base : kGroup);
    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      int r[kUnroll];
      float wt[kUnroll];
      float v[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;  // uniform over the group
        r[u] = -1;
        wt[u] = 0.f;
        int col = 0;
        if (j < cnt) {
          r[u] = __shfl_sync(gmask, my_row, j, kGroup);
          col = __shfl_sync(gmask, my_col, j, kGroup);
          wt[u] = __shfl_sync(gmask, my_w, j, kGroup);
        }
        const float* p = feats + static_cast<int64_t>(col) * f + c0;
        if (r[u] >= 0 && kVec && c0 + cidx[0] < f) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p + cidx[0]));
          v[u][0] = q.x;
          v[u][1] = q.y;
          v[u][2] = q.z;
          v[u][3] = q.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[u][k] = (!kVec && r[u] >= 0 && c0 + cidx[k] < f) ? __ldg(p + cidx[k]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r[u] < 0) continue;
        if (r[u] != cur) {
          flush();
          cur = r[u];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k] += kWeighted ? __fmul_rn(v[u][k], wt[u]) : v[u][k];
        }
      }
    }
  }
  flush();
}

template <int kGroup, bool kWeighted>
void launch_group(const int32_t* rows, const int32_t* cols, const float* w,
                  const float* feats, float* out, int64_t cap, int n, int f,
                  int chunk, cudaStream_t stream) {
  constexpr int kGroupsPerBlock = kWarpsPerBlock * (32 / kGroup);
  const int64_t groups = (cap + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>((groups + kGroupsPerBlock - 1) / kGroupsPerBlock),
                  (f + 4 * kGroup - 1) / (4 * kGroup));
  const dim3 block(kWarpsPerBlock * 32);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  if (vec) {
    spmm_rowid_kernel<kGroup, true, kWeighted><<<grid, block, 0, stream>>>(
        rows, cols, w, feats, out, cap, n, f, chunk);
  } else {
    spmm_rowid_kernel<kGroup, false, kWeighted><<<grid, block, 0, stream>>>(
        rows, cols, w, feats, out, cap, n, f, chunk);
  }
}

template <bool kWeighted>
void launch(const int32_t* rows, const int32_t* cols, const float* w,
            const float* feats, float* out, int64_t cap, int n, int f,
            int chunk, cudaStream_t stream) {
  const int lanes = (f + 3) / 4;
  if (lanes <= 1) {
    launch_group<1, kWeighted>(rows, cols, w, feats, out, cap, n, f, chunk, stream);
  } else if (lanes <= 2) {
    launch_group<2, kWeighted>(rows, cols, w, feats, out, cap, n, f, chunk, stream);
  } else if (lanes <= 4) {
    launch_group<4, kWeighted>(rows, cols, w, feats, out, cap, n, f, chunk, stream);
  } else if (lanes <= 8) {
    launch_group<8, kWeighted>(rows, cols, w, feats, out, cap, n, f, chunk, stream);
  } else if (lanes <= 16) {
    launch_group<16, kWeighted>(rows, cols, w, feats, out, cap, n, f, chunk, stream);
  } else {
    launch_group<32, kWeighted>(rows, cols, w, feats, out, cap, n, f, chunk, stream);
  }
}

}  // namespace

// Launches K6 on `stream` and returns cudaGetLastError() (0 on success).
// `rows`, `cols` are (cap,) int32, `w` (cap,) f32 or null (every slot with a
// real row id counts 1), `feats` (n, f) f32 contiguous, `out` (n, f) f32
// zeroed by the caller; each group of lanes takes `chunk` slots.
extern "C" int stg_spmm_rowid(const void* rows, const void* cols, const void* w,
                              const void* feats, void* out, int64_t cap, int n,
                              int f, int chunk, void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* x = static_cast<const float*>(feats);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (wt != nullptr) {
    launch<true>(r, c, wt, x, o, cap, n, f, chunk, s);
  } else {
    launch<false>(r, c, wt, x, o, cap, n, f, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
