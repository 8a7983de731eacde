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
// (818,716 edges) about 112 MB, 0.034 ms. On the rowmask route's Pubmed
// epoch (88,648 edges) the bound is 0.004 ms, so a launch and its
// dependent loads are the time.
//
// The first design (a warp a 1024-edge work item, the item's row, row
// bounds and start loaded one after the other before any value, split rows
// filled with -inf by the wrapper and finished by a second kernel) ran 4.5x
// its bound at PPI size (PERF.md §6). This design:
//   - walks host-built work items of at most `chunk` edges
//     (ops/segment_kernels.K5_CHUNK), each one int4 (row, first edge, end,
//     split slot): one load, where the first design chained three;
//   - gives an item kL = 16 lanes, so a warp walks two items, and inside
//     an item lanes are (edge offset, group of 4 columns) pairs: a column
//     tile (blockIdx.y) of kt <= 4 kL columns takes gp column groups (the
//     power of two at least kt / 4) and kL / gp edge offsets, so at K = 32
//     8 lanes read one 128 B edge row and the item takes two edges a step;
//   - keeps kU edges a lane in flight and issues the next batch's loads
//     before it compares this batch's values;
//   - loads 16 B a lane where K % 4 == 0 and the plane is aligned, scalars
//     otherwise (any K: the tiles' last one may be 1 column wide);
//   - meets an item's edge offsets by log2(kL / gp) shuffles a column;
//   - finishes a split row (more than `chunk` edges, so several items, and
//     several tiles when K > 4 kL) in the same launch: its items meet by an
//     atomic float max in a scratch row of -inf kept beside the work items,
//     and the last of them to take its row's ticket moves the scratch row
//     into `out` (-inf to 0) and leaves it -inf and the ticket 0 for the
//     next launch. No -inf fill, no second kernel: one launch a call.
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
constexpr int kL = 16;          // lanes a work item
constexpr int kU = 4;           // edges a lane keeps in flight
constexpr int kTile = 4 * kL;   // columns of one tile (blockIdx.y)
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNegInfBits = 0xff800000u;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(kNegInfBits); }

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

// One batch: the values of edges e0, e0 + step, ... (kU of them) at this
// lane's 4 columns, -inf past `end` or past the tile.
template <bool kVec>
__device__ __forceinline__ void load_batch(const float* p, int64_t k, int e0, int step, int end, int ncol,
                                           float (&v)[kU][4]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = e0 + u * step;
    const float* q = p + static_cast<int64_t>(e) * k;
    if (kVec) {
      if (e < end) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(q));
        v[u][0] = x.x;
        v[u][1] = x.y;
        v[u][2] = x.z;
        v[u][3] = x.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[u][c] = neg_inf();
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) v[u][c] = (e < end && c < ncol) ? __ldg(q + c) : neg_inf();
    }
  }
}

// kL lanes a work item (32 / kL items a warp); blockIdx.y the column tile.
template <bool kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_max_wide_kernel(const float* __restrict__ vals, const int4* __restrict__ items,
                        const int32_t* __restrict__ split_items, int* __restrict__ tickets,
                        float* __restrict__ scratch, float* __restrict__ out, int num_items, int k) {
  const int lane = threadIdx.x & 31;
  const int sl = lane % kL;  // the lane's place in its item
  const int item = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / kL) + lane / kL;
  const bool valid = item < num_items;  // not warp-uniform: every lane meets the shuffles
  int4 it = make_int4(0, 0, 0, -1);     // (row or ~row when split, first edge, end, split slot)
  if (valid) it = __ldg(items + item);
  const bool split = it.x < 0;
  const int row = split ? ~it.x : it.x;

  const int c0 = blockIdx.y * kTile;
  const int kt = min(kTile, k - c0);  // this tile's width, uniform over the block
  int gp = 1;
  while (4 * gp < kt) gp <<= 1;  // column groups, <= kL
  const int step = kL / gp;      // edges an item reads at once
  const int g = sl & (gp - 1);
  const int col = 4 * g;  // this lane's first column, in the tile
  const int ncol = min(4, kt - col);
  const bool active = valid && ncol > 0;

  float acc[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
  if (active) {
    const float* p = vals + c0 + col;
    const int end = it.z;
    float cur[kU][4];
    int e0 = it.y + sl / gp;
    load_batch<kVec>(p, k, e0, step, end, ncol, cur);
    for (; e0 < end; e0 += kU * step) {
      float nxt[kU][4];
      load_batch<kVec>(p, k, e0 + kU * step, step, end, ncol, nxt);  // ahead of this batch's compares
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c] = fmaxf(acc[c], cur[u][c]);
          cur[u][c] = nxt[u][c];
        }
      }
    }
  }
  // the item's edge offsets of one column group: sl, sl + gp, sl + 2 gp, ...
  for (int s = gp; s < kL; s <<= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = fmaxf(acc[c], __shfl_xor_sync(kFull, acc[c], s));
  }
  if (active && sl < gp) {
    if (!split) {
      float* o = out + static_cast<int64_t>(row) * k + c0 + col;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < ncol) o[c] = acc[c] == neg_inf() ? 0.f : acc[c];
      }
    } else {
      float* s = scratch + static_cast<int64_t>(it.w) * k + c0 + col;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < ncol) atomic_max_float(s + c, acc[c]);
      }
    }
  }

  // A split row's last item to finish (over every tile) moves its scratch
  // row into out, -inf to 0, and leaves the scratch row -inf.
  if (split) __threadfence();  // this lane's atomics before the item's ticket
  __syncwarp();
  int last = 0;
  if (valid && split && sl == 0) {
    const int total = __ldg(split_items + it.w) * static_cast<int>(gridDim.y);
    last = atomicAdd(tickets + it.w, 1) == total - 1;
    if (last) tickets[it.w] = 0;  // ready for the next launch
  }
  last = __shfl_sync(kFull, last, lane & ~(kL - 1));
  if (last) {
    __threadfence();
    float* s = scratch + static_cast<int64_t>(it.w) * k;
    float* o = out + static_cast<int64_t>(row) * k;
    for (int c = sl; c < k; c += kL) {
      const float m = __uint_as_float(atomicExch(reinterpret_cast<unsigned int*>(s + c), kNegInfBits));
      o[c] = m == neg_inf() ? 0.f : m;
    }
  }
}

}  // namespace

// Launches K5 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
// `vals` is the (capacity, k) f32 plane in CSR order; `items` holds
// `num_items` int4 work items (row, or ~row for a row split over several
// items; first edge; end; the split row's slot, or -1), every row of the
// CSR in at least one (ops/segment_kernels.k5_work_items). A split row's
// slot indexes `split_items` (its item count), `tickets` (int32 zeros) and
// the rows of `scratch` ((num_split, k) f32, every element -inf); the
// kernel leaves tickets 0 and scratch -inf. `out` is (n, k) f32; the
// kernel writes every element of every row that has an item.
extern "C" int stg_segment_max_wide(const void* vals, const void* items, int num_items,
                                    const void* split_items, int num_split, void* tickets,
                                    void* scratch, void* out, int k, void* stream) {
  if (k < 1 || num_items < 0 ||
      (num_split > 0 && (split_items == nullptr || tickets == nullptr || scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (num_items == 0) return static_cast<int>(cudaGetLastError());
  const auto* v = static_cast<const float*>(vals);
  const auto* it = static_cast<const int4*>(items);
  const auto* si = static_cast<const int32_t*>(split_items);
  auto* tk = static_cast<int*>(tickets);
  auto* sc = static_cast<float*>(scratch);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  constexpr int kItemsPerBlock = kWarpsPerBlock * (32 / kL);
  const dim3 grid((num_items + kItemsPerBlock - 1) / kItemsPerBlock, (k + kTile - 1) / kTile);
  const dim3 block(kWarpsPerBlock * 32);
  if (k % 4 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0) {
    segment_max_wide_kernel<true><<<grid, block, 0, s>>>(v, it, si, tk, sc, o, num_items, k);
  } else {
    segment_max_wide_kernel<false><<<grid, block, 0, s>>>(v, it, si, tk, sc, o, num_items, k);
  }
  return static_cast<int>(cudaGetLastError());
}
