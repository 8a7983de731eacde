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
// tombstoned slots keep their row id and carry w = 0. So in any chunk of
// slots, every row id strictly between the chunk's first and last row id
// lies wholly inside that chunk. The store changes every timestep on the
// device, so no host-built work list (K1's) can serve: the kernels find
// their work from the device arrays alone.
//
// What bounds it on an H100: memory. Two operations per gathered element; the
// compulsory bytes (rows, cols, w, the f32 table once, the f32 output once)
// give about 0.34 ms at the wiki-talk shape (N = 1.1M, 2.2M slots, F = 128),
// and the gathered rows (one per live slot) are about twice the table. At
// about 2 slots a row, the output is a third of the traffic, so it must be
// written once: zeroing it first and flushing every run by atomicAdd (a
// read and a write more) costs three times the output's bytes.
//
// What the design does about it (the edge-chunk design, each row written
// once):
//   - launch 1, the chunk plan (stg_rowid_chunk_plan): one warp a chunk of
//     `chunk` slots finds the chunk's first and last row id below n
//     (tombstones count: they keep their row id), or -1 for a chunk of
//     sentinels only, and zeroes those two rows of `out`. Only they can be
//     shared with another chunk. It also sets each row's bit in a bitmap of
//     the rows that have a slot (one atomicOr at the start of each run);
//   - launch 2, the sums (stg_spmm_rowid): a group of kGroup lanes
//     (kGroup = the smallest power of two with 4 * kGroup >= F, at most 32)
//     takes the same chunk, lanes across the features, 4 columns a lane (one
//     16 B load where aligned). It loads kGroup slots' (row, col, w) at once
//     and broadcasts them with shuffles, then gathers up to kUnroll feature
//     rows before it adds any, so several row reads are in flight a group;
//   - it tracks runs of equal row id over every slot below n: a tombstone
//     only skips its gather, so a row of tombstones alone is stored as 0. A
//     run of a row strictly inside the chunk is stored by one vector store;
//     the chunk's first and last rows meet the neighbouring chunks by
//     atomicAdd into the rows launch 1 zeroed;
//   - the rows with no slot anywhere are stored as zeros by launch 2's
//     other blocks, which stride over the rows and read the bitmap: a long
//     run of such rows (a store whose upper row ids have no slot yet) is
//     spread over the whole card, not left to the chunk before it. So `out`
//     needs no zeroing pass: every row is written once, apart from the
//     chunks' shared rows;
//   - the gather happens inside the kernel (the TPU kernel needed an XLA
//     pre-gather into a (cap, F) plane).
//
// The stream is f32 throughout (lazy_spmm casts its input to f32), the sums
// are f32; only their order differs from the plain version's. A row shared
// between chunks takes its chunks' partial sums in the atomics' order.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libspmm_rowid-<hash>.so spmm_rowid.cu

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int64_t kFillBlocks = 4 * 132;  // blocks of launch 2 that zero the rows no slot names

// Launch 1: the first and last row id below n of each chunk (-1 for none),
// the bit of every row that has a slot set in `present` (zeroed by the
// caller), and the chunks' first and last rows of `out` (n, f) zeroed (out
// may be null).
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowid_chunk_plan_kernel(const int32_t* __restrict__ rows, int64_t cap, int n,
                        int chunk, int32_t* __restrict__ first,
                        int32_t* __restrict__ last,
                        uint32_t* __restrict__ present,
                        float* __restrict__ out, int f, int64_t chunks) {
  const int lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (c >= chunks) return;  // warp-uniform
  const int64_t beg = c * chunk;
  const int64_t end = beg + chunk < cap ? beg + chunk : cap;
  int lo = INT_MAX;
  int hi = -1;
  for (int64_t e = beg + lane; e < end; e += 32) {
    const int r = rows[e];
    if (r < n) {
      lo = min(lo, r);
      hi = max(hi, r);
      if (e == 0 || rows[e - 1] != r) atomicOr(present + (r >> 5), 1u << (r & 31));
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (hi < 0) lo = -1;
  if (lane == 0) {
    first[c] = lo;
    last[c] = hi;
  }
  if (out == nullptr || hi < 0) return;
  for (int k = lane; k < f; k += 32) {
    out[static_cast<int64_t>(lo) * f + k] = 0.f;
    out[static_cast<int64_t>(hi) * f + k] = 0.f;
  }
}

// Launch 2. Blocks below `chunk_blocks` sum the chunks; the others store
// zeros in the rows whose bit in `present` is clear.
template <int kGroup, bool kVec, bool kWeighted>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_rowid_kernel(const int32_t* __restrict__ rows,
                  const int32_t* __restrict__ cols,
                  const float* __restrict__ w,
                  const float* __restrict__ feats,
                  const int32_t* __restrict__ first,
                  const int32_t* __restrict__ last,
                  const uint32_t* __restrict__ present,
                  float* __restrict__ out, int64_t cap, int n, int f,
                  int chunk, int chunk_blocks) {
  constexpr int kUnroll = kGroup < 8 ? kGroup : 8;
  constexpr int kCols = 4 * kGroup;  // columns a group covers per pass
  constexpr int kGroupsPerBlock = kWarpsPerBlock * (32 / kGroup);
  const int lane = threadIdx.x & 31;
  const int sub = lane % kGroup;
  const int group_in_block = (threadIdx.x >> 5) * (32 / kGroup) + lane / kGroup;
  const unsigned gmask =
      kGroup == 32 ? kFull : ((1u << (kGroup & 31)) - 1u) << (lane / kGroup * kGroup);
  const int c0 = blockIdx.y * kCols;

  // this lane's columns within the tile
  int cidx[4];
  bool live[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cidx[k] = kVec ? sub * 4 + k : k * kGroup + sub;
    live[k] = c0 + cidx[k] < f;
  }
  auto store = [&](int64_t r, const float (&v)[4]) {
    float* o = out + r * f + c0;
    if (kVec) {
      if (live[0]) *reinterpret_cast<float4*>(o + cidx[0]) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (live[k]) o[cidx[k]] = v[k];
      }
    }
  };

  if (static_cast<int>(blockIdx.x) >= chunk_blocks) {  // the rows no slot names
    const float zeros[4] = {0.f, 0.f, 0.f, 0.f};
    const int64_t stride = static_cast<int64_t>(gridDim.x - chunk_blocks) * kGroupsPerBlock;
    for (int64_t r = static_cast<int64_t>(blockIdx.x - chunk_blocks) * kGroupsPerBlock + group_in_block; r < n;
         r += stride) {
      if (!((present[r >> 5] >> (r & 31)) & 1u)) store(r, zeros);
    }
    return;
  }

  const int64_t c = static_cast<int64_t>(blockIdx.x) * kGroupsPerBlock + group_in_block;
  const int64_t beg = c * chunk;
  if (beg >= cap) return;  // uniform over the group
  const int64_t end = beg + chunk < cap ? beg + chunk : cap;
  const int shared_lo = first[c];  // the rows other chunks may share
  const int shared_hi = last[c];

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cur = -1;  // row id of the run in acc, -1 before the first
  auto flush = [&]() {
    if (cur < 0) return;
    if (cur == shared_lo || cur == shared_hi) {
      float* o = out + static_cast<int64_t>(cur) * f + c0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (live[k]) atomicAdd(o + cidx[k], acc[k]);
      }
    } else {
      store(cur, acc);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = 0.f;
  };

  for (int64_t base = beg; base < end; base += kGroup) {
    const int64_t e = base + sub;
    int my_row = n;
    int my_col = 0;
    float my_w = 0.f;
    if (e < end) {
      my_row = rows[e];
      my_w = kWeighted ? w[e] : 1.f;
      my_col = cols[e];
    }
    const int cnt = static_cast<int>(end - base < kGroup ? end - base : kGroup);
    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      int r[kUnroll];
      float wt[kUnroll];
      float v[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;  // uniform over the group
        r[u] = n;
        wt[u] = 0.f;
        int col = 0;
        if (j < cnt) {
          r[u] = __shfl_sync(gmask, my_row, j, kGroup);
          col = __shfl_sync(gmask, my_col, j, kGroup);
          wt[u] = __shfl_sync(gmask, my_w, j, kGroup);
        }
        // a sentinel or a tombstone gathers nothing
        const bool gather = r[u] < n && wt[u] != 0.f;
        const float* p = feats + static_cast<int64_t>(col) * f + c0;
        if (gather && kVec && live[0]) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(p + cidx[0]));
          v[u][0] = q.x;
          v[u][1] = q.y;
          v[u][2] = q.z;
          v[u][3] = q.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[u][k] = (!kVec && gather && live[k]) ? __ldg(p + cidx[k]) : 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r[u] >= n) continue;  // a sentinel (or past the chunk)
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
                  const float* feats, const int32_t* first, const int32_t* last,
                  const uint32_t* present, float* out, int64_t cap, int n,
                  int f, int chunk, cudaStream_t stream) {
  constexpr int kGroupsPerBlock = kWarpsPerBlock * (32 / kGroup);
  const int64_t groups = (cap + chunk - 1) / chunk;
  const int chunk_blocks = static_cast<int>((groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
  // blocks that store the rows no slot names: enough for a row a group,
  // at most a few waves of the card
  const int64_t fill_blocks = std::min<int64_t>((n + kGroupsPerBlock - 1) / kGroupsPerBlock, kFillBlocks);
  const dim3 grid(static_cast<unsigned>(chunk_blocks + fill_blocks), (f + 4 * kGroup - 1) / (4 * kGroup));
  const dim3 block(kWarpsPerBlock * 32);
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    spmm_rowid_kernel<kGroup, true, kWeighted><<<grid, block, 0, stream>>>(
        rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, chunk_blocks);
  } else {
    spmm_rowid_kernel<kGroup, false, kWeighted><<<grid, block, 0, stream>>>(
        rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, chunk_blocks);
  }
}

template <bool kWeighted>
void launch(const int32_t* rows, const int32_t* cols, const float* w,
            const float* feats, const int32_t* first, const int32_t* last,
            const uint32_t* present, float* out, int64_t cap, int n, int f,
            int chunk, cudaStream_t stream) {
  const int lanes = (f + 3) / 4;
  if (lanes <= 1) {
    launch_group<1, kWeighted>(rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, stream);
  } else if (lanes <= 2) {
    launch_group<2, kWeighted>(rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, stream);
  } else if (lanes <= 4) {
    launch_group<4, kWeighted>(rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, stream);
  } else if (lanes <= 8) {
    launch_group<8, kWeighted>(rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, stream);
  } else if (lanes <= 16) {
    launch_group<16, kWeighted>(rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, stream);
  } else {
    launch_group<32, kWeighted>(rows, cols, w, feats, first, last, present, out, cap, n, f, chunk, stream);
  }
}

}  // namespace

// Launch 1 of K6 on `stream`; returns cudaGetLastError() (0 on success).
// `rows` is (cap,) int32; `first` and `last` receive (ceil(cap / chunk),)
// int32: each chunk's first and last row id below n, -1 for a chunk without
// one. `present` ((n + 31) / 32 words, zeroed by the caller) receives bit
// r % 32 of word r / 32 for every row r with a slot. The chunks' first and
// last rows of `out` ((n, f) f32) are zeroed, unless `out` is null.
extern "C" int stg_rowid_chunk_plan(const void* rows, int64_t cap, int n,
                                    int chunk, void* first, void* last,
                                    void* present, void* out, int f,
                                    void* stream) {
  const int64_t chunks = (cap + chunk - 1) / chunk;
  if (chunks > 0) {
    const dim3 grid(static_cast<unsigned>((chunks + kWarpsPerBlock - 1) / kWarpsPerBlock));
    rowid_chunk_plan_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(rows), cap, n, chunk, static_cast<int32_t*>(first),
        static_cast<int32_t*>(last), static_cast<uint32_t*>(present), static_cast<float*>(out), f, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launch 2 of K6 on `stream`; returns cudaGetLastError() (0 on success).
// `rows`, `cols` are (cap,) int32, `w` (cap,) f32 or null (every slot with a
// row id below n counts 1), `feats` (n, f) f32 contiguous, `out` (n, f) f32
// after launch 1 on it; `first`, `last` and `present` launch 1's plan; each
// group of lanes takes `chunk` slots.
extern "C" int stg_spmm_rowid(const void* rows, const void* cols, const void* w,
                              const void* feats, const void* first,
                              const void* last, const void* present,
                              void* out, int64_t cap, int n, int f, int chunk,
                              void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* x = static_cast<const float*>(feats);
  const auto* fi = static_cast<const int32_t*>(first);
  const auto* la = static_cast<const int32_t*>(last);
  const auto* pr = static_cast<const uint32_t*>(present);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (wt != nullptr) {
    launch<true>(r, c, wt, x, fi, la, pr, o, cap, n, f, chunk, s);
  } else {
    launch<false>(r, c, wt, x, fi, la, pr, o, cap, n, f, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
