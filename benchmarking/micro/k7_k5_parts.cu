// Probes of K7's and K5's first design, and K7's two-launch plan design, for
// benchmarking/micro/k7_k5_bench.py: each first kernel with its parts apart,
// to time them alone on the card. It is not part of the port and no path
// calls it.
//
// K7's first design (stgraph_tpu_torch/csrc/rowid_denom.cu before its
// redesign): a thread a run of `chunk` slots, each run of one row summed in
// a register and flushed by atomicAdd into den, zeroed by the wrapper:
//
//   kPhase 0: the whole kernel (as the first design; a check of the copy);
//   kPhase 1: the slot stream alone: rows and w read and the runs summed as
//             in 0, no atomic (a run's sum kept only where it could never
//             be stored, so the loads stay);
//   kPhase 2: the atomics alone: no slot read, the row ids made from the
//             slot index at the store's mean density (cap / n slots a
//             row), one atomicAdd a run as in 0.
//
// K5's first design (csrc/segment_max_wide.cu before its redesign): a warp
// a work item of at most 1024 edges (its row, the row's bounds and its
// first edge loaded one after the other), lanes as (edge offset, group of
// 4 columns), split rows by atomic max into rows the wrapper filled with
// -inf and a second kernel mapping -inf to 0 (stg_k5_clear_neg_inf here):
//
//   kPhase 0: the whole kernel (split rows left at their atomic maximum);
//   kPhase 1: the item walk alone: every metadata load, the loop over the
//             item's edges, the meeting and the stores, no value read (a
//             value made from the edge id);
//   kPhase 2: the value stream with its bounds at hand: each item's first
//             edge and end read from a host-made int2 (one load, no chain),
//             then the values, the meeting and the stores as in 0.
//
// K7's plan design (stg_k7_plan_design), timed against the look-back design
// that the port ships: K6's plan on K7's coalesced spans, two launches.
// Launch 1 gives each span (a warp, `passes` x 128 slots) its first and last
// live row, zeroes those two rows of den (the only rows a span can share)
// and sets the bit of every row that has a slot in `present`; launch 2 walks
// the span as the port's kernel does (16 B loads, the segmented warp scan),
// stores each row strictly inside the span once, adds the span's first and
// last rows by atomicAdd, and its extra blocks zero every row whose bit is
// clear and clear the bitmap's words for the next call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk7_k5_parts.so k7_k5_parts.cu

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// ---- K7's first design -----------------------------------------------------

template <int kPhase>
__global__ void __launch_bounds__(kThreads)
k7_probe_kernel(const int32_t* __restrict__ rows, const float* __restrict__ w, float* __restrict__ den,
                int64_t cap, int n, int chunk) {
  const int64_t beg = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * chunk;
  if (beg >= cap) return;
  const int64_t end = beg + chunk < cap ? beg + chunk : cap;
  const double density = static_cast<double>(n) / static_cast<double>(cap);
  int cur = -1;
  float acc = 0.f;
  for (int64_t e = beg; e < end; ++e) {
    const int r = kPhase == 2 ? static_cast<int>(static_cast<double>(e) * density) : rows[e];
    if (r < 0 || r >= n) continue;
    if (r != cur) {
      if (cur >= 0) {
        if (kPhase == 1) {
          if (acc == -1.2345f) den[cur] = acc;  // never: the loads stay
        } else {
          atomicAdd(den + cur, acc);
        }
      }
      cur = r;
      acc = 0.f;
    }
    acc += (kPhase != 2 && w != nullptr) ? w[e] : 1.f;
  }
  if (cur >= 0) {
    if (kPhase == 1) {
      if (acc == -1.2345f) den[cur] = acc;
    } else {
      atomicAdd(den + cur, acc);
    }
  }
}

// ---- K5's first design -----------------------------------------------------

template <int kPhase>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k5_probe_kernel(const int32_t* __restrict__ indptr, const float* __restrict__ vals,
                const int32_t* __restrict__ item_row, const int32_t* __restrict__ item_beg,
                const int2* __restrict__ bounds, float* __restrict__ out, int num_items, int k, int chunk) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;
  const int row = item_row[item];
  int beg, end;
  bool split;
  if (kPhase == 2) {
    const int2 b = bounds[item];
    beg = b.x;
    end = b.y;
    split = false;
  } else {
    const int row_beg = indptr[row];
    const int row_end = indptr[row + 1];
    beg = item_beg[item];
    end = min(beg + chunk, row_end);
    split = row_end - row_beg > chunk;
  }
  const int c0 = blockIdx.y * kTile;
  const int kt = min(kTile, k - c0);
  const int groups = (kt + 3) >> 2;
  int gp = 1;
  while (gp < groups) gp <<= 1;
  const int step = 32 / gp;
  const int g = lane & (gp - 1);
  const int col = 4 * g;
  const bool active = col < kt;
  float acc[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
  if (active) {
#pragma unroll 4
    for (int e = beg + lane / gp; e < end; e += step) {
      if (kPhase == 1) {
        acc[0] = fmaxf(acc[0], __int_as_float(e & 0x3fffff));
      } else {
        const float4 q = __ldg(reinterpret_cast<const float4*>(vals + static_cast<int64_t>(e) * k + c0 + col));
        acc[0] = fmaxf(acc[0], q.x);
        acc[1] = fmaxf(acc[1], q.y);
        acc[2] = fmaxf(acc[2], q.z);
        acc[3] = fmaxf(acc[3], q.w);
      }
    }
  }
  for (int s = gp; s < 32; s <<= 1) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc[kk] = fmaxf(acc[kk], __shfl_xor_sync(kFull, acc[kk], s));
  }
  if (lane < gp && active) {
    float* o = out + static_cast<int64_t>(row) * k + c0 + col;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (col + kk < kt) {
        if (split) {
          const float v = acc[kk];
          if (__float_as_int(v) >= 0) {
            atomicMax(reinterpret_cast<int*>(o + kk), __float_as_int(v));
          } else {
            atomicMin(reinterpret_cast<unsigned int*>(o + kk), __float_as_uint(v));
          }
        } else {
          o[kk] = acc[kk] == neg_inf() ? 0.f : acc[kk];
        }
      }
    }
  }
}

__global__ void k5_clear_neg_inf_kernel(const int64_t* __restrict__ rows, int num_rows, int k,
                                        float* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(num_rows) * k) return;
  float* o = out + rows[i / k] * k + i % k;
  if (*o == neg_inf()) *o = 0.f;
}

// ---- K7's plan design ------------------------------------------------------

constexpr int kV = 4;
constexpr int kPass = 32 * kV;
constexpr int64_t kFillBlocks = 4 * 132;

struct Seg {
  int f, l;
  float s;
};

__device__ __forceinline__ Seg none() { return Seg{-1, -1, 0.f}; }

__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  if (b.l < 0) return a;
  if (a.l < 0) return b;
  return Seg{a.f, b.l, b.l == a.l ? a.s + b.s : b.s};
}

__device__ __forceinline__ Seg shfl_seg(const Seg& x, int src) {
  return Seg{__shfl_sync(kFull, x.f, src), __shfl_sync(kFull, x.l, src), __shfl_sync(kFull, x.s, src)};
}

template <int kMode, int kP>
__device__ __forceinline__ void load_span(const int32_t* rows, const float* w, int64_t span, int64_t cap, int n,
                                          int lane, int (&r)[kP][kV], float (&v)[kP][kV]) {
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int64_t e = span * (kP * kPass) + p * kPass + kV * lane;
    if (e + kV <= cap) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(rows + e));
      r[p][0] = q.x;
      r[p][1] = q.y;
      r[p][2] = q.z;
      r[p][3] = q.w;
      if (kMode != 0) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(w + e));
        v[p][0] = x.x;
        v[p][1] = x.y;
        v[p][2] = x.z;
        v[p][3] = x.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        r[p][j] = e + j < cap ? __ldg(rows + e + j) : n;
        if (kMode != 0) v[p][j] = e + j < cap ? __ldg(w + e + j) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const float x = kMode != 0 ? v[p][j] : 0.f;
      v[p][j] = kMode == 0 ? 1.f : (kMode == 1 ? x : (x > 0.f ? 1.f : 0.f));
      if (r[p][j] < 0 || r[p][j] >= n) r[p][j] = -1;
    }
  }
}

template <int kP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k7_plan_kernel(const int32_t* __restrict__ rows, float* __restrict__ den, uint32_t* __restrict__ present,
               int64_t cap, int n, int64_t spans) {
  const int lane = threadIdx.x & 31;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= spans) return;
  int r[kP][kV];
  float v[kP][kV];
  load_span<0, kP>(rows, nullptr, s, cap, n, lane, r, v);
  int lo = INT_MAX, hi = -1;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int rj = r[p][j];
      if (rj < 0) continue;
      lo = min(lo, rj);
      hi = max(hi, rj);
      const int64_t e = s * (kP * kPass) + p * kPass + kV * lane + j;
      if (e == 0 || rows[e - 1] != rj) atomicOr(present + (rj >> 5), 1u << (rj & 31));
    }
  }
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  if (lane == 0 && hi >= 0) {
    den[lo] = 0.f;
    den[hi] = 0.f;
  }
}

template <int kMode, int kP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
k7_sums_kernel(const int32_t* __restrict__ rows, const float* __restrict__ w, float* __restrict__ den,
               uint32_t* __restrict__ present, int64_t cap, int n, int64_t spans, int span_blocks) {
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) >= span_blocks) {  // the rows with no slot; the bitmap cleared
    const int64_t words = (n + 31) / 32;
    const int64_t stride = static_cast<int64_t>(gridDim.x - span_blocks) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x - span_blocks) * blockDim.x + threadIdx.x; i < words;
         i += stride) {
      const uint32_t bits = present[i];
      for (int b = 0; b < 32 && i * 32 + b < n; ++b) {
        if (!((bits >> b) & 1u)) den[i * 32 + b] = 0.f;
      }
      present[i] = 0u;
    }
    return;
  }
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (s >= spans) return;
  int r[kP][kV];
  float v[kP][kV];
  load_span<kMode, kP>(rows, w, s, cap, n, lane, r, v);
  Seg ex[kP], tot[kP];
  Seg agg = none();
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    Seg m = none();
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int rj = r[p][j];
      if (rj < 0) continue;
      if (m.l < 0) {
        m = Seg{rj, rj, v[p][j]};
      } else if (rj == m.l) {
        m.s += v[p][j];
      } else {
        m.l = rj;
        m.s = v[p][j];
      }
    }
    Seg x = m;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Seg y = shfl_seg(x, lane >= d ? lane - d : lane);
      if (lane >= d) x = combine(y, x);
    }
    const Seg prev = shfl_seg(x, lane > 0 ? lane - 1 : 0);
    ex[p] = lane > 0 ? prev : none();
    tot[p] = shfl_seg(x, 31);
    agg = combine(agg, tot[p]);
  }
  Seg c = none();
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const Seg in = combine(c, ex[p]);
    int prev = in.l;
    float acc = in.s;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int rj = r[p][j];
      if (rj < 0) continue;
      if (rj != prev) {
        if (prev >= 0) {
          if (prev == agg.f) {
            atomicAdd(den + prev, acc);
          } else {
            den[prev] = acc;
          }
        }
        prev = rj;
        acc = 0.f;
      }
      acc += v[p][j];
    }
    c = combine(c, tot[p]);
  }
  if (lane == 0 && agg.l >= 0) atomicAdd(den + agg.l, c.s);
}

template <int kMode, int kP>
void plan_design(const int32_t* rows, const float* w, float* den, uint32_t* present, int64_t cap, int n,
                 cudaStream_t st) {
  const int64_t spans = (cap + kP * kPass - 1) / (kP * kPass);
  const int span_blocks = static_cast<int>((spans + kWarpsPerBlock - 1) / kWarpsPerBlock);
  k7_plan_kernel<kP><<<span_blocks, kWarpsPerBlock * 32, 0, st>>>(rows, den, present, cap, n, spans);
  const int64_t words = (n + 31) / 32;
  int64_t fill = (words + kWarpsPerBlock * 32 - 1) / (kWarpsPerBlock * 32);
  fill = fill < kFillBlocks ? fill : kFillBlocks;
  k7_sums_kernel<kMode, kP><<<static_cast<unsigned>(span_blocks + fill), kWarpsPerBlock * 32, 0, st>>>(
      rows, w, den, present, cap, n, spans, span_blocks);
}

template <int kMode>
void plan_design_p(const int32_t* rows, const float* w, float* den, uint32_t* present, int64_t cap, int n,
                   int passes, cudaStream_t st) {
  if (passes == 1) {
    plan_design<kMode, 1>(rows, w, den, present, cap, n, st);
  } else if (passes == 2) {
    plan_design<kMode, 2>(rows, w, den, present, cap, n, st);
  } else {
    plan_design<kMode, 4>(rows, w, den, present, cap, n, st);
  }
}

}  // namespace

extern "C" int stg_k7_probe(const void* rows, const void* w, void* den, int64_t cap, int n, int chunk, int phase,
                            void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* wt = static_cast<const float*>(w);
  auto* d = static_cast<float*>(den);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t threads = (cap + chunk - 1) / chunk;
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (phase == 0) {
    k7_probe_kernel<0><<<blocks, kThreads, 0, st>>>(r, wt, d, cap, n, chunk);
  } else if (phase == 1) {
    k7_probe_kernel<1><<<blocks, kThreads, 0, st>>>(r, wt, d, cap, n, chunk);
  } else {
    k7_probe_kernel<2><<<blocks, kThreads, 0, st>>>(r, wt, d, cap, n, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// `vals` (capacity, k) f32 with k % 4 == 0 and 16 B aligned; `bounds` (num_items,) int2 (first edge, end) for
// phase 2, else unused.
extern "C" int stg_k5_probe(const void* indptr, const void* vals, const void* item_row, const void* item_beg,
                            const void* bounds, int num_items, void* out, int k, int chunk, int phase,
                            void* stream) {
  if (k % 4 != 0 || reinterpret_cast<uintptr_t>(vals) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock, (k + kTile - 1) / kTile);
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* v = static_cast<const float*>(vals);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  const auto* b = static_cast<const int2*>(bounds);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (phase == 0) {
    k5_probe_kernel<0><<<grid, kWarpsPerBlock * 32, 0, st>>>(ip, v, ir, ib, b, o, num_items, k, chunk);
  } else if (phase == 1) {
    k5_probe_kernel<1><<<grid, kWarpsPerBlock * 32, 0, st>>>(ip, v, ir, ib, b, o, num_items, k, chunk);
  } else {
    k5_probe_kernel<2><<<grid, kWarpsPerBlock * 32, 0, st>>>(ip, v, ir, ib, b, o, num_items, k, chunk);
  }
  return static_cast<int>(cudaGetLastError());
}

// The first K5's second kernel: -inf to 0 in the split rows.
extern "C" int stg_k5_clear_neg_inf(const void* split_rows, int num_split, int k, void* out, void* stream) {
  const int64_t total = static_cast<int64_t>(num_split) * k;
  if (total > 0) {
    const auto blocks = static_cast<unsigned>((total + 255) / 256);
    auto st = static_cast<cudaStream_t>(stream);
    k5_clear_neg_inf_kernel<<<blocks, 256, 0, st>>>(static_cast<const int64_t*>(split_rows), num_split, k,
                                                   static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// K7's plan design: two launches into `den` ((n,) f32, any contents); `present` ((n + 31) / 32 uint32) zero
// on entry and left zero; `w` null in mode 0; rows and w 16 B aligned.
extern "C" int stg_k7_plan_design(const void* rows, const void* w, void* den, void* present, int64_t cap, int n,
                                  int mode, int passes, void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* wt = static_cast<const float*>(w);
  auto* d = static_cast<float*>(den);
  auto* pr = static_cast<uint32_t*>(present);
  auto st = static_cast<cudaStream_t>(stream);
  if (cap < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    plan_design_p<0>(r, wt, d, pr, cap, n, passes, st);
  } else if (mode == 1) {
    plan_design_p<1>(r, wt, d, pr, cap, n, passes, st);
  } else {
    plan_design_p<2>(r, wt, d, pr, cap, n, passes, st);
  }
  return static_cast<int>(cudaGetLastError());
}
