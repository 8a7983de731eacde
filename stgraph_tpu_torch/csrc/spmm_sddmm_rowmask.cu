// K2 on Hopper: the fused backward of the weighted row-wise SpMM, for one
// head or many. Called on the TRANSPOSE CSR (rows = source nodes s, cols =
// destinations d) with the weights in transpose edge order:
//
//   dh[s, c]  = sum_{e in [indptr[s], indptr[s+1])} w[e, c / F] * g[cols[e], c]
//   dw[e, h]  = < fs[s, h-columns], g[cols[e], h-columns] >   (0 on padding slots)
//
// for H heads of F columns each (one head: w and dw are (E,)). g is the
// cotangent of the forward SpMM's output and fs its input features.
// Replaces the TPU kernel segment_pallas._spmm_sddmm_rowmask_kernel
// (stgraph_tpu/ops/segment_pallas.py:1248, reached from spmm_rowmask_bwd at
// pallas_call :1555): the weighted backward of the GCN training path (one
// head) and of the composed GAT route's rowmask branch (heads,
// stgraph_tpu/ops/attention.py:313-317).
//
// What bounds it on an H100: memory. Per edge it does 4 operations per
// feature (the dh product and sum, the dw product and sum), while the gather
// of g[cols[e]] touches E * H * F elements spread over a table far larger
// than the 50 MB L2. The compulsory bytes (indptr, cols, w and dw once, the
// g and fs tables once, dh once) give a bound of about 1.6 ms at
// ogbn-products size and F = 128; the gathered rows are about 20x that, so,
// as for K1, the time is set by how many random row reads the card keeps in
// flight.
//
// The first design (a warp an edge, lanes across the row, one edge a step,
// a five-shuffle dot and two broadcasts per edge) took 97 % of F = 128's
// time at F = 47 for 37 % of the bytes (PERF.md §6, measured on an H100).
// This design is K1's (csrc/spmm_rowmask.cu) with the SDDMM folded in:
//   - a group of G lanes takes an edge, one 16 B load a lane, with G the
//     row's (or the column tile's) 16 B pieces rounded up to a power of two
//     (ops/spmm_kernels.k1_lanes): a warp takes 32 / G edges a step (F = 128
//     bf16: 2; F = 47 bf16, padded to 48: 4), and issues the gathers of
//     kSteps steps (a round) before it forms any product;
//   - 32 (col, w) pairs of the item are loaded at once, coalesced, and
//     broadcast by shuffle; with heads the group loads its edge's weight
//     row as one vector a lane, contiguous across the group;
//   - fs[row] is row-local: each lane keeps its own columns in registers,
//     rounded to the stream once per item;
//   - in bf16 both products (dh's w g and dw's fs g) are packed bf16x2
//     multiplies: one rounding of the exact product, bit-equal to the first
//     design's round_to_bf16(__fmul_rn(a, b)) for every pair of bf16 values
//     (K1's bf16_product_check holds the identity over all 2^32 pairs);
//   - one head: each lane forms the partial dots of the round's kSteps
//     edges it loaded; the group folds them by a transpose reduction (each
//     shuffle level hands half of the values to the partner lane), so
//     log2(G) + kSteps - 1 shuffles serve a round's 32 / G x kSteps edges
//     instead of five shuffles an edge; one more shuffle hands each edge's
//     dot to the lane of its position among the item's 32 loaded edges, and
//     the warp stores 32 dw values as one 128 B line;
//   - heads: a lane's 16 B hold columns of one head or of 16 B / (elem F)
//     whole heads (at 32 x 4 bf16: two): its heads' dots need no shuffle,
//     or log2(lanes a head) shuffles; the lane holding a head's first column
//     stores its dots, so a group stores its edge's dw row contiguously;
//   - widths past one tile (f32 past 128 columns, bf16 past 256): the warp
//     walks the tiles itself, in an outer loop, and adds each tile's dot into
//     dw[e] (one head; with heads every head lies inside one tile); the lane
//     that stores an edge's dw is the same in every tile, so the read-modify-
//     write is race free;
//   - an f32 table whose row stride is not a multiple of 4 columns (or not
//     16 B aligned) takes K1's aligned-down loads: the group reads the row
//     from its start rounded down to 16 B and each lane turns its four
//     values by the row's offset into its own columns and its neighbour's;
//     it keeps fs on both, so the dot needs no hand-over, and dh's
//     neighbour columns move over by one shuffle per item;
//   - a row with more than `chunk` edges (the host picks `chunk` by mode:
//     ops/spmm_kernels.K2_CHUNK) is split into work items whose dh partials
//     meet by atomicAdd in rows the wrapper zeroed; dw[e, :] belongs to
//     exactly one item: a plain store. Every other dh row is stored once;
//   - in bf16-stream mode the wrapper casts g to a bf16 table once (row
//     stride padded to a multiple of 8, as K1); fs stays f32 and is rounded
//     to bf16 as it is read, which saves a cast pass over it.
//
// Rounding matches the TPU kernel (segment_pallas.py:1380-1414): with a
// bf16 stream, dh's product of the bf16 weight and the bf16 g value is
// rounded to bf16 and summed in f32, and dw's elementwise products of the
// bf16 fs and g values are rounded to bf16 and summed over the head's
// features in f32; with an f32 stream every step is f32 (each product
// rounded, then added). Only the order of f32 sums differs.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libspmm_sddmm_rowmask-<hash>.so \
//        spmm_sddmm_rowmask.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// How the weights reach a lane's columns.
constexpr int kShared = 1;  // one head: one weight an edge, shuffled
constexpr int kHeads = 2;   // heads: the lane's kNH heads, one vector load

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) { return __uint_as_float(pair & 0xffff0000u); }

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// Two bf16 values as one pair: `lo` in the low half.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return bf16_bits(lo) | (bf16_bits(hi) << 16);
}

// Both products of a pair, each the exact product rounded once to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The lane's weights of one edge: kNH consecutive heads from w_row[0].
template <int kNH>
__device__ __forceinline__ void load_heads(const float* w_row, float (&wv)[kNH]) {
  if constexpr (kNH == 1) {
    wv[0] = __ldg(w_row);
  } else if constexpr (kNH == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(w_row));
    wv[0] = q.x;
    wv[1] = q.y;
  } else {
#pragma unroll
    for (int i = 0; i < kNH; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(w_row + i));
      wv[i] = q.x;
      wv[i + 1] = q.y;
      wv[i + 2] = q.z;
      wv[i + 3] = q.w;
    }
  }
}

// kNH dots of one edge into dw's row at `d` (aligned to kNH floats).
template <int kNH>
__device__ __forceinline__ void store_heads(float* d, const float (&dots)[kNH]) {
  if constexpr (kNH == 1) {
    *d = dots[0];
  } else if constexpr (kNH == 2) {
    *reinterpret_cast<float2*>(d) = make_float2(dots[0], dots[1]);
  } else {
#pragma unroll
    for (int i = 0; i < kNH; i += 4) {
      *reinterpret_cast<float4*>(d + i) = make_float4(dots[i], dots[i + 1], dots[i + 2], dots[i + 3]);
    }
  }
}

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x >> 1); }

// a[i] for a run-time i < 4, by selects (no local memory).
template <typename V>
__device__ __forceinline__ V pick4(const V (&a)[4], int i) {
  return i == 0 ? a[0] : i == 1 ? a[1] : i == 2 ? a[2] : a[3];
}

// One warp per work item (a row, or a piece of at most `chunk` edges of
// one); the warp walks column tiles of `tile` columns itself. T: the stream
// (float or __nv_bfloat16); kG lanes an edge; kNH heads a lane (kHeads);
// kMis: an f32 table whose rows are not 16 B aligned (one head only).
template <typename T, int kW, int kG, int kNH, bool kMis>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_sddmm_rowmask_kernel(const int32_t* __restrict__ indptr,
                          const int32_t* __restrict__ cols,
                          const float* __restrict__ w,
                          const T* __restrict__ g,
                          const float* __restrict__ fs,
                          const int32_t* __restrict__ item_row,
                          const int32_t* __restrict__ item_beg,
                          float* __restrict__ dh, float* __restrict__ dw,
                          int num_items, int f, int ld, int heads, int head_f,
                          int chunk, int tile) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kV = 16 / sizeof(T);                      // columns a lane loads
  constexpr int kEps = 32 / kG;                           // edges a step
  constexpr int kSteps = kEps * 4 <= 32 ? 4 : 32 / kEps;  // steps a round, <= kG
  constexpr int kRound = kSteps * kEps;                   // edges a round, divides 32
  constexpr int kAcc = kMis ? 2 * kV : kV;
  constexpr int kFoldShift = log2i(kG) - log2i(kSteps);   // see the dw fold below
  static_assert(kSteps <= kG, "the dw fold needs a lane a step");

  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;  // warp-uniform
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  const int grp = lane / kG;  // the edge of a step this lane takes
  const int sub = lane % kG;  // its 16 B piece of the row
  const int col = sub * kV;   // its first column (aligned tables)
  const float* fs_row = fs + static_cast<int64_t>(row) * f;
  float* dh_row = dh + static_cast<int64_t>(row) * f;

  for (int c0 = 0; c0 < f; c0 += tile) {
    const int tw = min(tile, f - c0);  // columns of this tile
    const bool active = col < tw;      // aligned tables: the lane holds columns of the tile
    // fs on the lane's columns, as the stream carries it: bf16 pairs, or
    // f32 values (kMis: also the columns of the lane before, xp)
    uint32_t xq[kV / 2];
    float x[4], xp[4];
    bool own_ok[4], prev_ok[4];
    if constexpr (kBf16) {
#pragma unroll
      for (int m = 0; m < kV / 2; ++m) {
        const int c = col + 2 * m;
        xq[m] = bf16_pair(c < tw ? __ldg(fs_row + c0 + c) : 0.f, c + 1 < tw ? __ldg(fs_row + c0 + c + 1) : 0.f);
      }
    } else {
      const int first = kMis ? 4 * sub : col;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = first + k < tw ? __ldg(fs_row + c0 + first + k) : 0.f;
        if constexpr (kMis) {
          own_ok[k] = first + k < tw;
          prev_ok[k] = sub > 0 && first - 4 + k < tw;
          xp[k] = prev_ok[k] ? __ldg(fs_row + c0 + first - 4 + k) : 0.f;
        }
      }
    }
    // heads: the lane's first head, and whether it stores its heads' dots
    // (kNH > 1: every active lane; else the first of a head's lanes)
    int head0 = 0;
    bool opens = false;
    int lph = 1;  // lanes a head (kNH == 1)
    if constexpr (kW == kHeads) {
      head0 = min(c0 + col, f - 1) / head_f;
      lph = kNH > 1 ? 1 : head_f / kV;
      opens = active && (kNH > 1 || (c0 + col) % head_f == 0);
    }

    float acc[kAcc];
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;

    for (int base = beg; base < end; base += 32) {
      const int cnt = min(32, end - base);  // warp-uniform
      int my_col = 0;
      uint32_t my_w = 0;  // one head: the stream's weight, f32 bits or a bf16 pair
      if (lane < cnt) {
        my_col = __ldg(cols + base + lane);
        if constexpr (kW == kShared) {
          const float raw = __ldg(w + base + lane);
          my_w = kBf16 ? bf16_pair(raw, raw) : __float_as_uint(raw);
        }
      }
      float my_dw = 0.f;  // one head: this tile's dot of edge base + lane
      for (int j0 = 0; j0 < cnt; j0 += kRound) {
        // the gathers of kSteps steps first ...
        uint4 q[kSteps];
        uint32_t wq[kSteps];
        float wv[kSteps][kNH];
        int shift[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int j = j0 + u * kEps + grp;  // < 32
          const bool ok = j < cnt;
          const int src = __shfl_sync(kFull, my_col, j);
          wq[u] = kW == kShared ? __shfl_sync(kFull, my_w, j) : 0u;
          shift[u] = 0;
          q[u] = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (kW == kHeads) {
#pragma unroll
            for (int h = 0; h < kNH; ++h) wv[u][h] = 0.f;
            if (ok && active) load_heads<kNH>(w + static_cast<int64_t>(base + j) * heads + head0, wv[u]);
          }
          const T* row_p = g + static_cast<int64_t>(src) * ld + c0;
          if constexpr (kMis) {
            const uintptr_t a = reinterpret_cast<uintptr_t>(row_p);
            shift[u] = static_cast<int>((a >> 2) & 3u);
            const float* a0 = reinterpret_cast<const float*>(a & ~static_cast<uintptr_t>(15));
            if (ok && 4 * sub < shift[u] + tw) q[u] = __ldg(reinterpret_cast<const uint4*>(a0 + 4 * sub));
          } else {
            if (ok && active) q[u] = __ldg(reinterpret_cast<const uint4*>(row_p + col));
          }
        }
        // ... then both products of each step (a step past the end adds zeros)
        float d[kSteps];  // one head: the lane's partial dot of each step's edge
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const uint32_t qa[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
          float dots[kNH];
#pragma unroll
          for (int h = 0; h < kNH; ++h) dots[h] = 0.f;
          if constexpr (kBf16) {
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              uint32_t wp = wq[u];
              if constexpr (kW == kHeads) {
                // columns 2m and 2m + 1 of the lane's 8 belong to heads
                // (2m) * kNH / 8 and (2m + 1) * kNH / 8 of its kNH
                wp = bf16_pair(wv[u][(2 * m) * kNH / 8], wv[u][(2 * m + 1) * kNH / 8]);
              }
              const uint32_t p = mul_bf16x2(qa[m], wp);
              acc[2 * m] += bf16_lo(p);
              acc[2 * m + 1] += bf16_hi(p);
              const uint32_t r = mul_bf16x2(xq[m], qa[m]);
              dots[(2 * m) * kNH / 8] += bf16_lo(r);
              dots[(2 * m + 1) * kNH / 8] += bf16_hi(r);
            }
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float v = __uint_as_float(qa[k]);
              const float wt = kW == kShared ? __uint_as_float(wq[u]) : wv[u][k * kNH / 4];
              if constexpr (kMis) {
                // v is column 4 sub + k - s of the tile: slot (k - s) of this
                // lane for k >= s, slot (k - s + 4) of the lane before
                // otherwise (K1's rotation, done on the products here)
                const int s = shift[u];
                const int slot = (k - s) & 3;
                const bool mine = k >= s;
                const float xx = mine ? pick4(x, slot) : pick4(xp, slot);
                const bool ok = mine ? pick4(own_ok, slot) : pick4(prev_ok, slot);
                dots[0] += ok ? __fmul_rn(xx, v) : 0.f;
              } else {
                acc[k] += __fmul_rn(v, wt);
                dots[k * kNH / 4] += __fmul_rn(x[k], v);
              }
            }
            if constexpr (kMis) {
              // dh: the rotation onto own slots (acc[k]) and the lane
              // before's (acc[4 + k]), as K1 does it
              const int s = shift[u];
              const float wt = __uint_as_float(wq[u]);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const float r = __fmul_rn(__uint_as_float(pick4(qa, (k + s) & 3)), wt);
                if (k + s < 4) {
                  acc[k] += r;
                } else {
                  acc[4 + k] += r;
                }
              }
            }
          }
          if constexpr (kW == kShared) {
            d[u] = dots[0];
          } else {
            // heads: the head's lanes meet (lph > 1), then its first lane stores
            for (int s = lph >> 1; s > 0; s >>= 1) dots[0] += __shfl_xor_sync(kFull, dots[0], s);
            const int j = j0 + u * kEps + grp;
            if (opens && j < cnt) store_heads<kNH>(dw + static_cast<int64_t>(base + j) * heads + head0, dots);
          }
        }
        if constexpr (kW == kShared) {
          // The dw fold: the group's kG lanes sum the kSteps partial dots of
          // their edges by a transpose reduction. At each level the lane
          // keeps one half of its values, hands the other to its partner
          // (lane ^ s) and adds the partner's half of the same steps; once
          // one value is left the remaining levels add it alone. The lane
          // ends holding the dot of step (sub >> kFoldShift), read with its
          // bits in order from the highest of sub.
#pragma unroll
          for (int lvl = 0, s = kG >> 1; s > 0; ++lvl, s >>= 1) {
            const int half = (kSteps >> lvl) >> 1;
            if (half > 0) {
              const bool upper = (lane & s) != 0;
#pragma unroll
              for (int i = 0; i < kSteps / 2; ++i) {
                if (i < half) {
                  const float send = upper ? d[i] : d[half + i];
                  const float keep = upper ? d[half + i] : d[i];
                  d[i] = keep + __shfl_xor_sync(kFull, send, s);
                }
              }
            } else {
              d[0] += __shfl_xor_sync(kFull, d[0], s);
            }
          }
          // lane L takes the dot of the item's edge base + L: step u =
          // (L - j0) / kEps of group (L - j0) % kEps, held by that group's
          // lane u << kFoldShift
          const int t = (lane - j0) & (kRound - 1);
          const int from = (t % kEps) * kG + ((t / kEps) << kFoldShift);
          const float dot = __shfl_sync(kFull, d[0], from);
          if (lane >= j0 && lane < j0 + kRound) my_dw = dot;
        }
      }
      // one head: the warp's 32 dots as one line; a later tile adds to the
      // first's (the same lane owns the edge in every tile)
      if (kW == kShared && lane < cnt) {
        float* o = dw + base + lane;
        *o = c0 == 0 ? my_dw : *o + my_dw;
      }
    }

    // dh: the groups' partial sums meet: lanes sub, sub + kG, sub + 2 kG, ...
#pragma unroll
    for (int s = kG; s < 32; s <<= 1) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], s);
    }
    int first = col;  // the first tile column this lane stores
    if constexpr (kMis) {
      // the columns the next lane turned over to this one
      first = 4 * sub;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float from_next = __shfl_down_sync(kFull, acc[4 + k], 1, kG);
        acc[k] += sub + 1 < kG ? from_next : 0.f;
      }
    }
    if (grp == 0 && first < tw) {
      constexpr int kOut = kMis ? 4 : kV;
      float* o = dh_row + c0 + first;
      const bool vec = !split && first + kOut <= tw && (reinterpret_cast<uintptr_t>(o) & 15u) == 0;
      if (vec) {
#pragma unroll
        for (int k = 0; k < kOut; k += 4) {
          *reinterpret_cast<float4*>(o + k) = make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kOut; ++k) {
          if (first + k < tw) {
            if (split) {
              atomicAdd(o + k, acc[k]);
            } else {
              o[k] = acc[k];
            }
          }
        }
      }
    }
  }
}

struct Args {
  const int32_t* indptr;
  const int32_t* cols;
  const float* w;
  const void* g;
  const float* fs;
  const int32_t* item_row;
  const int32_t* item_beg;
  float* dh;
  float* dw;
  int num_items, f, ld, heads, chunk, tile;
  cudaStream_t stream;
};

template <typename T, int kW, int kG, int kNH, bool kMis>
void launch(const Args& a) {
  const dim3 grid((a.num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  spmm_sddmm_rowmask_kernel<T, kW, kG, kNH, kMis><<<grid, kWarpsPerBlock * 32, 0, a.stream>>>(
      a.indptr, a.cols, a.w, static_cast<const T*>(a.g), a.fs, a.item_row, a.item_beg, a.dh, a.dw,
      a.num_items, a.f, a.ld, a.heads, a.f / a.heads, a.chunk, a.tile);
}

// One head: any lane group.
template <typename T, bool kMis>
bool launch_one_head(const Args& a, int lanes) {
  switch (lanes) {
    case 1: launch<T, kShared, 1, 1, kMis>(a); return true;
    case 2: launch<T, kShared, 2, 1, kMis>(a); return true;
    case 4: launch<T, kShared, 4, 1, kMis>(a); return true;
    case 8: launch<T, kShared, 8, 1, kMis>(a); return true;
    case 16: launch<T, kShared, 16, 1, kMis>(a); return true;
    case 32: launch<T, kShared, 32, 1, kMis>(a); return true;
    default: return false;
  }
}

// Several heads: the JAX tiling (128 % F == 0, H * F % 128 == 0) makes a
// tile 128 f32 columns (32 lanes) or 128-256 bf16 columns (16 or 32).
template <typename T, int kNH>
bool launch_heads_nh(const Args& a, int lanes) {
  if (lanes == 32) {
    launch<T, kHeads, 32, kNH, false>(a);
    return true;
  }
  if constexpr (sizeof(T) == 2) {
    if (lanes == 16) {
      launch<T, kHeads, 16, kNH, false>(a);
      return true;
    }
  }
  return false;
}

template <typename T>
bool launch_heads(const Args& a, int lanes) {
  constexpr int kV = 16 / sizeof(T);
  const int head_f = a.f / a.heads;
  const int nh = head_f >= kV ? 1 : kV / head_f;
  if (head_f < kV ? kV % head_f != 0 : head_f % kV != 0) return false;
  if (a.tile % head_f != 0) return false;  // every head inside one tile
  switch (nh) {
    case 1: return launch_heads_nh<T, 1>(a, lanes);
    case 2: return launch_heads_nh<T, 2>(a, lanes);
    case 4: return launch_heads_nh<T, 4>(a, lanes);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_heads_nh<T, 8>(a, lanes);
      return false;
    default: return false;
  }
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel was not built for.
// `g` is (num_cols, ld) with ld >= f = heads * F, f32 or bf16 by `g_bf16`;
// a bf16 table and any table with heads must have 16 B aligned rows (ld a
// multiple of 8 or 4, an aligned base). `fs` is (n, f) f32; `w` and `dw` are
// (capacity, heads) f32 in this CSR's edge order (with heads both 16 B
// aligned); `dh` is (n, f) f32. The caller zeroes the dh rows of split work
// items and the padding slots of dw; the kernel writes every other element
// of both. `lanes` lanes take an edge and the warp walks tiles of `tile`
// columns: ops/spmm_kernels.k1_lanes.
extern "C" int stg_spmm_sddmm_rowmask(const void* indptr, const void* cols,
                                      const void* w, const void* g, int g_bf16,
                                      const void* fs, const void* item_row,
                                      const void* item_beg, int num_items,
                                      void* dh, void* dw, int f, int ld,
                                      int heads, int chunk, int lanes, int tile,
                                      void* stream) {
  Args a;
  a.indptr = static_cast<const int32_t*>(indptr);
  a.cols = static_cast<const int32_t*>(cols);
  a.w = static_cast<const float*>(w);
  a.g = g;
  a.fs = static_cast<const float*>(fs);
  a.item_row = static_cast<const int32_t*>(item_row);
  a.item_beg = static_cast<const int32_t*>(item_beg);
  a.dh = static_cast<float*>(dh);
  a.dw = static_cast<float*>(dw);
  a.num_items = num_items;
  a.f = f;
  a.ld = ld;
  a.heads = heads;
  a.chunk = chunk;
  a.tile = tile;
  a.stream = static_cast<cudaStream_t>(stream);
  if (heads < 1 || f < 1 || f % heads != 0 || tile < 1 || chunk < 1 || w == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vcols = g_bf16 ? 8 : 4;
  const bool aligned = ld % vcols == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  bool ok;
  if (heads > 1) {
    const bool w_aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(dw) % 16 == 0;
    ok = aligned && w_aligned && tile % vcols == 0 &&
         (g_bf16 ? launch_heads<__nv_bfloat16>(a, lanes) : launch_heads<float>(a, lanes));
  } else if (g_bf16) {
    ok = aligned && launch_one_head<__nv_bfloat16, false>(a, lanes);
  } else if (aligned) {
    ok = launch_one_head<float, false>(a, lanes);
  } else {
    ok = launch_one_head<float, true>(a, lanes);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
