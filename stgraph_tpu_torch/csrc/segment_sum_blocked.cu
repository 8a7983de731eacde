// K10 on Hopper: the multi-head weighted segment sum over the blocked layout.
//
//   out[d, c] = sum_{slots s with dst[s] == d} w[s, c / F] * feats[cols[s], c]
//
// for c < H * F, over the blocked layout of graph/blocked.py: row blocks of
// 128 destinations, each block's slots in CSR order (so sorted by dst) and
// padded with sentinel slots (dst = cols = n) to a multiple of 1024. `w` is
// (CB, H) f32 in slot order, `feats` the (n, H * F) f32 node table, `out`
// (n, H * F) f32. Sentinel slots add nothing and are never gathered (their
// cols = n is out of the table's bounds).
//
// Replaces the TPU kernel spmm_pallas._seg_matmul_kernel
// (stgraph_tpu/ops/spmm_pallas.py:61, reached from segment_sum_blocked at
// pallas_call :196) on the composed GAT route: the forward's weighted
// aggregation, and d feat on the transpose layout in backward, for the
// head tilings the row-wise kernel's multi-head mode would not take (H > 1
// with 128 % F != 0 or (H * F) % 128 != 0; the GAT paper's PPI widths,
// 4 x 256 and 6 x 121). The TPU kernel multiplied a 0/1 selection matrix
// into rows that XLA had gathered before it; here the gather is inside the
// kernel, as in K1 and K6: at ogbn-products size and H * F = 1024 the
// gathered rows would be a 507 GB intermediate.
//
// What bounds it on an H100: memory. Two operations per gathered element;
// the compulsory bytes (dst, cols, w, the table once, the output once) give
// about 7 ms at ogbn-products size and H * F = 1024, while the gathered rows
// (one 4 KB row per slot) are about 25 times the table, so the time is set by
// how many row reads the card keeps in flight.
//
// What the design does about it (K6's edge-chunk design):
//   - a warp takes a fixed run of `chunk` slots and one tile of 128 columns
//     (blockIdx.y), lanes across the columns, 4 a lane (one 16 B load where
//     H * F % 4 == 0): a gathered row tile is one coalesced 512 B read;
//   - the warp loads 32 slots' (dst, col) at once and broadcasts them with
//     shuffles, then gathers up to kUnroll rows before it adds any, so
//     several row reads are in flight per warp;
//   - the head of each column is c / F, computed per column, never per tile:
//     at F = 121 head boundaries fall inside a tile and inside a lane's four
//     columns;
//   - it sums runs of equal dst in registers (a row's slots are contiguous
//     and dst-sorted within a block) and stores a run that lies wholly
//     inside its chunk; only a row that also owns the slot just before or
//     just after the chunk is shared with another warp, and that row's run
//     meets the others by atomicAdd in the output, which the wrapper zeroed.
//     So a hub block of 10^5-10^6 slots is spread over many warps, and most
//     rows cost one store a column. The order of the atomics, and so the
//     last bits of a row split between chunks, varies from run to run;
//   - where a lane's four columns lie in one head (F % 4 == 0) it reads one
//     weight a slot, else one a column;
//   - sentinel slots (dst >= n) are skipped before the gather, wherever they
//     sit, so the layout's chunk padding costs only their (dst, col) reads;
//     the blocks' offsets and counts are not needed.
//
// The stream is f32 (the JAX package streams bf16 only on the rowmask
// route), the products and sums are f32; only the sums' order differs from
// the plain version's.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_sum_blocked-<hash>.so \
//        segment_sum_blocked.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;  // columns a warp covers per pass
constexpr int kUnroll = 8;  // row gathers in flight per warp
constexpr unsigned kFull = 0xffffffffu;

// kVec: lane l owns columns 4l..4l+3 of the tile (needs hf % 4 == 0 and a
// 16 B aligned table); otherwise columns l, l+32, l+64, l+96.
// kOneHead (with kVec, when f % 4 == 0): a lane's four columns lie in one
// head, so it reads one weight a slot instead of four.
template <bool kVec, bool kOneHead>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_blocked_kernel(const int32_t* __restrict__ dst,
                           const int32_t* __restrict__ cols,
                           const float* __restrict__ w,
                           const float* __restrict__ feats,
                           float* __restrict__ out, int64_t cb, int n, int hf,
                           int f, int heads, int chunk) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t beg = warp * chunk;
  if (beg >= cb) return;  // warp-uniform
  const int64_t end = beg + chunk < cb ? beg + chunk : cb;
  const int c0 = blockIdx.y * kTile;
  // A row's slots are contiguous, so only a row that also owns the slot
  // just before or just after the chunk is shared with another warp.
  const int prev_dst = beg > 0 ? dst[beg - 1] : -1;
  const int next_dst = end < cb ? dst[end] : -1;

  // this lane's columns within the tile, and the head of each
  int cidx[4];
  int head[4];
  bool live[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cidx[k] = kVec ? lane * 4 + k : k * 32 + lane;
    live[k] = c0 + cidx[k] < hf;
    head[k] = live[k] ? (c0 + cidx[k]) / f : 0;
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cur = -1;  // dst of the run in acc, -1 before the first

  // A run wholly inside the chunk is stored; a shared row meets the other
  // warps' partial sums by atomicAdd in the zeroed output.
  auto flush = [&]() {
    if (cur < 0) return;
    float* o = out + static_cast<int64_t>(cur) * hf + c0;
    if (cur == prev_dst || cur == next_dst) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (live[k]) atomicAdd(o + cidx[k], acc[k]);
      }
    } else if (kVec) {
      if (live[0]) *reinterpret_cast<float4*>(o + cidx[0]) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (live[k]) o[cidx[k]] = acc[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = 0.f;
  };

  for (int64_t base = beg; base < end; base += 32) {
    const int64_t s = base + lane;
    int my_dst = -1;
    int my_col = 0;
    if (s < end) {
      const int d = dst[s];
      if (d < n) {  // a sentinel slot is skipped before any gather
        my_dst = d;
        my_col = cols[s];
      }
    }
    const int cnt = static_cast<int>(end - base < 32 ? end - base : 32);
    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      int d[kUnroll];
      float v[kUnroll][4];
      float wt[kUnroll][kOneHead ? 1 : 4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;  // warp-uniform
        d[u] = -1;
        int col = 0;
        if (j < cnt) {
          d[u] = __shfl_sync(kFull, my_dst, j);
          col = __shfl_sync(kFull, my_col, j);
        }
        const float* p = feats + static_cast<int64_t>(col) * hf + c0;
        // the weights of one slot sit in one 64 B line that every lane
        // reads, so after the first read these are L1 hits
        const float* ws = w + (base + j) * heads;
        if (d[u] >= 0 && kVec && live[0]) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p + cidx[0]));
          v[u][0] = q.x;
          v[u][1] = q.y;
          v[u][2] = q.z;
          v[u][3] = q.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[u][k] = (!kVec && d[u] >= 0 && live[k]) ? __ldg(p + cidx[k]) : 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < (kOneHead ? 1 : 4); ++k) {
          wt[u][k] = (d[u] >= 0 && live[k]) ? __ldg(ws + head[k]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (d[u] < 0) continue;  // warp-uniform
        if (d[u] != cur) {
          flush();
          cur = d[u];
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += __fmul_rn(v[u][k], wt[u][kOneHead ? 0 : k]);
      }
    }
  }
  flush();
}

}  // namespace

// Launches K10 on `stream` and returns cudaGetLastError() (0 on success).
// `dst`, `cols` are (cb,) int32 in blocked slot order, `w` (cb, heads) f32,
// `feats` (n, hf) f32 contiguous with hf = heads * f, `out` (n, hf) f32
// zeroed by the caller; each warp takes `chunk` slots.
extern "C" int stg_segment_sum_blocked(const void* dst, const void* cols,
                                       const void* w, const void* feats,
                                       void* out, int64_t cb, int n, int hf,
                                       int f, int heads, int chunk,
                                       void* stream) {
  const auto* d = static_cast<const int32_t*>(dst);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* x = static_cast<const float*>(feats);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t warps = (cb + chunk - 1) / chunk;
  const dim3 grid(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (hf + kTile - 1) / kTile);
  const dim3 block(kWarpsPerBlock * 32);
  const bool vec = hf % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(o) % 16 == 0;
  if (vec && f % 4 == 0) {
    segment_sum_blocked_kernel<true, true><<<grid, block, 0, s>>>(d, c, wt, x, o, cb, n, hf, f, heads, chunk);
  } else if (vec) {
    segment_sum_blocked_kernel<true, false><<<grid, block, 0, s>>>(d, c, wt, x, o, cb, n, hf, f, heads, chunk);
  } else {
    segment_sum_blocked_kernel<false, false><<<grid, block, 0, s>>>(d, c, wt, x, o, cb, n, hf, f, heads, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}
