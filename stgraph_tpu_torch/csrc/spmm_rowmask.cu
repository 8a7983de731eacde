// K1 on Hopper: row-wise weighted SpMM over a CSR, for one head or many,
// with the softmax denominator.
//
//   out[d, c] = sum_{e in [indptr[d], indptr[d+1])} w[e, c / F] * feats[cols[e], c]
//   den[d, h] = sum_{e in [indptr[d], indptr[d+1])} w[e, h]        (optional)
//
// for H heads of F columns each (w is (E, H) in CSR order; one head takes
// an (E,) w, or none for the unweighted sum).
//
// Replaces the TPU kernel segment_pallas._spmm_rowmask_kernel
// (stgraph_tpu/ops/segment_pallas.py:761, reached from spmm_rowmask at
// pallas_call :1083): the forward SpMM of the GCN paths (one head), and the
// composed GAT route's rowmask branch (heads > 1 and the denominator,
// stgraph_tpu/ops/attention.py:250-256). Its no-gather mode, the same TPU
// kernel run on an (E, K) plane without weights, is csrc/segment_sum_wide.cu.
// It is also the traced variant, spmm_rowmask_traced (segment_pallas.py:1136,
// pallas_call at :1223), which the distribution layer runs on each shard's
// rectangular CSR (ops/spmm_kernels.spmm_rowmask_traced): nothing here
// assumes a square graph, since `feats` is indexed by `cols` alone and `out`
// by the work items' rows, and the traced metadata is the work list.
//
// What bounds it on an H100: memory. It does 2 operations per gathered
// element, while the gather of feats[cols[e]] touches E * H * F elements
// spread over the whole table (at ogbn-products size the bf16 table is
// 627 MB at F = 128, far above the 50 MB L2). The compulsory bytes (cols,
// w, the table once, the output once) give a bound of about 1 ms at
// F = 128; the gathered rows are about 25x that.
//
// The first design (a warp an edge, lanes across the row, one edge a step)
// was set by its walk, not by its bytes: F = 47 in bf16 (96 B rows) took
// 91 % of the time of F = 128 (256 B rows), and the bf16 arithmetic alone
// cost 12 % at F = 128 (PERF.md §6, measured on an H100). This design:
//   - gives each edge a group of G lanes, one 16 B load a lane, with G the
//     row's (or the column tile's) 16 B pieces rounded up to a power of two
//     (ops/spmm_kernels.k1_lanes): a warp takes 32 / G edges a step (F = 128
//     bf16: 2; F = 47 bf16, padded to 48: 4; F = 64 f32: 2), and the groups'
//     partial sums meet by shuffles once per work item, not once per edge;
//   - loads 32 (col, w) pairs of the item at once, coalesced, and
//     broadcasts them by shuffle;
//   - issues the gathers of kSteps steps before it adds any of them, so each
//     lane keeps several rows in flight;
//   - in bf16 forms each product as one packed bf16x2 multiply of the
//     gathered pair by the weight pair (mul.rn.bf16x2). The exact product
//     of two bf16 values fits in f32, so one rounding of it to bf16 equals
//     the first design's round_to_bf16(__fmul_rn(x, w)) for every finite
//     pair, subnormal, overflowing and signed-zero products included (the
//     rounding of the exact product to f32 is exact, or it lies below half
//     the least bf16 subnormal, where both round to zero). bf16_product_check
//     below holds the two bit for bit over all 2^32 pairs on the card;
//   - where an f32 table's row stride is not a multiple of 4 columns (the
//     shard mode at F = 47), or the table is not 16 B aligned, a lane still
//     makes one aligned 16 B load: the group reads the row from its start
//     rounded down to 16 B, lanes past the row's end load nothing, and
//     each lane turns its four values by the row's offset (0-3 columns,
//     known per edge) into the columns it holds and the columns its
//     neighbour holds, which it hands over by one shuffle per item;
//   - with several heads, a lane's 16 B hold columns of 16 B / (4 F) heads
//     (at least one): it loads those heads' weights of the edge as one
//     vector, and the lane holding a head's first column sums the head's
//     denominator from the same unrounded weights;
//   - one head: each lane adds the weights of the edges it loaded for the
//     denominator, and the warp sums them once per item;
//   - a row with more than `chunk` edges is split into several work items
//     (the host picks `chunk` by mode: ops/spmm_kernels.K1_CHUNK) whose
//     partial sums (and denominators) meet by atomicAdd in rows the
//     wrapper zeroed; every other row is stored once, so no output is
//     zeroed whole;
//   - in bf16-stream mode the wrapper casts the table to bf16 once (N x F)
//     with the row stride padded to a multiple of 8 (16 B), so every bf16
//     load is aligned.
//
// Rounding matches the TPU kernel (segment_pallas.py:860-906): with a bf16
// stream the gathered value and the weight are bf16, their product is
// rounded to bf16, and the sum is taken in f32; with an f32 stream every
// step is f32 (the product rounded, then added). The denominator sums the
// unrounded f32 weights in f32. Only the order of the f32 sums differs.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libspmm_rowmask-<hash>.so spmm_rowmask.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

// How the weights reach a lane's columns.
constexpr int kNoWeight = 0;  // unweighted
constexpr int kShared = 1;    // one head: one weight an edge, shuffled
constexpr int kHeads = 2;     // heads: the lane's kNH heads, one vector load

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

// The first design's product of a bf16 value and a bf16 weight, kept for
// bf16_product_check.
__device__ __forceinline__ uint32_t formula_bf16_product(uint32_t x, uint32_t w) {
  return bf16_bits(__fmul_rn(__uint_as_float(x << 16), __uint_as_float(w << 16)));
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

// One warp per work item (a row, or a piece of at most `chunk` edges of
// one), blockIdx.y over column tiles of `tile` columns. T: the stream
// (float or __nv_bfloat16); kG lanes an edge; kNH heads a lane (kHeads);
// kMis: an f32 table whose rows are not 16 B aligned (one head only).
template <typename T, int kW, int kG, int kNH, bool kMis>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_rowmask_kernel(const int32_t* __restrict__ indptr,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ w,
                    const T* __restrict__ feats,
                    const int32_t* __restrict__ item_row,
                    const int32_t* __restrict__ item_beg,
                    float* __restrict__ out, float* __restrict__ den,
                    int num_items, int f, int ld, int heads, int head_f,
                    int chunk, int tile) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kV = 16 / sizeof(T);              // columns a lane loads
  constexpr int kEps = 32 / kG;                   // edges a step
  constexpr int kSteps = kEps * 4 <= 32 ? 4 : 32 / kEps;  // steps in flight
  constexpr int kRound = kSteps * kEps;           // edges a round, divides 32
  constexpr int kAcc = kMis ? 2 * kV : kV;

  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;  // warp-uniform
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  const int c0 = blockIdx.y * tile;
  const int tw = min(tile, f - c0);  // columns of this tile
  const int grp = lane / kG;         // the edge of a step this lane takes
  const int sub = lane % kG;         // its 16 B piece of the row
  const int col = sub * kV;          // its first column (aligned tables)
  const bool active = col < tw;      // aligned tables: the lane holds columns of the tile
  const bool want_den = den != nullptr;

  // heads: the lane's first head, and whether it opens a head (holds the
  // head's first column) and so sums the denominator
  int head0 = 0;
  bool opens = false;
  if (kW == kHeads) {
    head0 = min(c0 + col, f - 1) / head_f;
    opens = want_den && active && (kNH > 1 || (c0 + col) % head_f == 0);
  }

  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) acc[k] = 0.f;
  float dacc[kNH];
#pragma unroll
  for (int h = 0; h < kNH; ++h) dacc[h] = 0.f;
  float dsum = 0.f;  // one head: the weights of the edges this lane loaded

  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);  // warp-uniform
    int my_col = 0;
    uint32_t my_w = 0;  // the stream's weight: f32 bits, or a bf16 pair
    if (lane < cnt) {
      my_col = __ldg(cols + base + lane);
      if (kW == kShared) {
        const float raw = __ldg(w + base + lane);
        dsum += raw;
        my_w = kBf16 ? bf16_pair(raw, raw) : __float_as_uint(raw);
      }
    }
    for (int j0 = 0; j0 < cnt; j0 += kRound) {
      // the gathers of kSteps steps first ...
      uint4 q[kSteps];
      uint32_t wq[kSteps];
      float wv[kSteps][kNH];
      int shift[kSteps];
      bool ok[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int j = j0 + u * kEps + grp;  // < 32
        ok[u] = j < cnt;
        const int src = __shfl_sync(kFull, my_col, j);
        wq[u] = kW == kShared ? __shfl_sync(kFull, my_w, j) : 0u;
        shift[u] = 0;
        q[u] = make_uint4(0u, 0u, 0u, 0u);
        if (kW == kHeads) {
#pragma unroll
          for (int h = 0; h < kNH; ++h) wv[u][h] = 0.f;
          if (ok[u] && active) load_heads<kNH>(w + static_cast<int64_t>(base + j) * heads + head0, wv[u]);
        }
        const T* row_p = feats + static_cast<int64_t>(src) * ld + c0;
        if (kMis) {
          const uintptr_t a = reinterpret_cast<uintptr_t>(row_p);
          shift[u] = static_cast<int>((a >> 2) & 3u);
          const float* a0 = reinterpret_cast<const float*>(a & ~static_cast<uintptr_t>(15));
          if (ok[u] && 4 * sub < shift[u] + tw) {
            q[u] = __ldg(reinterpret_cast<const uint4*>(a0 + 4 * sub));
          }
        } else if (ok[u] && active) {
          q[u] = __ldg(reinterpret_cast<const uint4*>(row_p + col));
        }
      }
      // ... then their sums (a step past the batch's end adds zeros)
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const uint32_t qa[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
        if (kBf16) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            uint32_t p = qa[m];
            if (kW == kShared) {
              p = mul_bf16x2(p, wq[u]);
            } else if (kW == kHeads) {
              // columns 2m and 2m + 1 of the lane's 8 belong to heads
              // (2m) * kNH / 8 and (2m + 1) * kNH / 8 of its kNH
              p = mul_bf16x2(p, bf16_pair(wv[u][(2 * m) * kNH / 8], wv[u][(2 * m + 1) * kNH / 8]));
            }
            acc[2 * m] += bf16_lo(p);
            acc[2 * m + 1] += bf16_hi(p);
          }
          if (kW == kHeads && opens) {
#pragma unroll
            for (int h = 0; h < kNH; ++h) dacc[h] += wv[u][h];
          }
        } else {
          float v[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            float x = __uint_as_float(qa[k]);
            if (kW == kShared) {
              x = __fmul_rn(x, __uint_as_float(wq[u]));
            } else if (kW == kHeads) {
              x = __fmul_rn(x, wv[u][k * kNH / 4]);
            }
            v[k] = x;
          }
          if (kMis) {
            // v[k] is column 4 sub + k - s of the tile: slot (k - s) of this
            // lane for k >= s, slot (k - s + 4) of the lane before otherwise
            const int s = shift[u];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float r = v[(k + s) & 3];  // column 4 sub + k, or 4 (sub - 1) + k
              if (k + s < 4) {
                acc[k] += r;
              } else {
                acc[4 + k] += r;
              }
            }
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k] += v[k];
          }
          if (kW == kHeads && opens) {
#pragma unroll
            for (int h = 0; h < kNH; ++h) dacc[h] += wv[u][h];
          }
        }
      }
    }
  }

  // the groups' partial sums meet: lanes sub, sub + kG, sub + 2 kG, ...
#pragma unroll
  for (int s = kG; s < 32; s <<= 1) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], s);
    if (kW == kHeads) {
#pragma unroll
      for (int h = 0; h < kNH; ++h) dacc[h] += __shfl_xor_sync(kFull, dacc[h], s);
    }
  }
  int first = col;  // the first tile column this lane stores
  if (kMis) {
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
    float* o = out + static_cast<int64_t>(row) * f + c0 + first;
    const bool vec = !split && first + kOut <= tw &&
                     (reinterpret_cast<uintptr_t>(o) & 15u) == 0;
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
  if (!want_den) return;
  float* d = den + static_cast<int64_t>(row) * heads;
  if (kW == kShared) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) dsum += __shfl_xor_sync(kFull, dsum, s);
    if (lane == 0 && blockIdx.y == 0) {
      if (split) {
        atomicAdd(d, dsum);
      } else {
        *d = dsum;
      }
    }
  } else if (kW == kHeads && grp == 0 && opens) {
#pragma unroll
    for (int h = 0; h < kNH; ++h) {
      if (split) {
        atomicAdd(d + head0 + h, dacc[h]);
      } else {
        d[head0 + h] = dacc[h];
      }
    }
  }
}

struct Args {
  const int32_t* indptr;
  const int32_t* cols;
  const float* w;
  const void* feats;
  const int32_t* item_row;
  const int32_t* item_beg;
  float* out;
  float* den;
  int num_items, f, ld, heads, chunk, tile;
  dim3 grid;
  cudaStream_t stream;
};

template <typename T, int kW, int kG, int kNH, bool kMis>
void launch(const Args& a) {
  spmm_rowmask_kernel<T, kW, kG, kNH, kMis><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
      a.indptr, a.cols, a.w, static_cast<const T*>(a.feats), a.item_row,
      a.item_beg, a.out, a.den, a.num_items, a.f, a.ld, a.heads,
      a.f / a.heads, a.chunk, a.tile);
}

// One head (unweighted or shared weights): any lane group.
template <typename T, int kW, bool kMis>
bool launch_one_head(const Args& a, int g) {
  switch (g) {
    case 1: launch<T, kW, 1, 1, kMis>(a); return true;
    case 2: launch<T, kW, 2, 1, kMis>(a); return true;
    case 4: launch<T, kW, 4, 1, kMis>(a); return true;
    case 8: launch<T, kW, 8, 1, kMis>(a); return true;
    case 16: launch<T, kW, 16, 1, kMis>(a); return true;
    case 32: launch<T, kW, 32, 1, kMis>(a); return true;
    default: return false;
  }
}

// Several heads: the JAX tiling (128 % F == 0, H * F % 128 == 0) makes a
// tile 128 f32 columns (32 lanes) or 128-256 bf16 columns (16 or 32).
template <typename T, int kNH>
bool launch_heads_nh(const Args& a, int g) {
  if (g == 32) {
    launch<T, kHeads, 32, kNH, false>(a);
    return true;
  }
  if constexpr (sizeof(T) == 2) {
    if (g == 16) {
      launch<T, kHeads, 16, kNH, false>(a);
      return true;
    }
  }
  return false;
}

template <typename T>
bool launch_heads(const Args& a, int g) {
  constexpr int kV = 16 / sizeof(T);
  const int head_f = a.f / a.heads;
  const int nh = head_f >= kV ? 1 : kV / head_f;
  if (head_f < kV ? kV % head_f != 0 : head_f % kV != 0) return false;
  switch (nh) {
    case 1: return launch_heads_nh<T, 1>(a, g);
    case 2: return launch_heads_nh<T, 2>(a, g);
    case 4: return launch_heads_nh<T, 4>(a, g);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_heads_nh<T, 8>(a, g);
      return false;
    default: return false;
  }
}

// The bf16 packed product against the first design's formula over n pairs
// (x, w) taken from `first` on: pair p is x = p >> 16, w = p & 0xffff.
// Counts the pairs whose results differ in any bit, NaN results excepted
// (where both are NaN), and records the first such pair.
__global__ void bf16_product_check_kernel(uint64_t first, uint64_t n,
                                          unsigned long long* mismatches,
                                          unsigned long long* nan_pairs,
                                          unsigned long long* first_bad) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  unsigned long long bad = 0, nans = 0;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const uint64_t p = first + i;
    const uint32_t x = static_cast<uint32_t>(p >> 16) & 0xffffu;
    const uint32_t w = static_cast<uint32_t>(p) & 0xffffu;
    const uint32_t packed = mul_bf16x2(x | (x << 16), w | (w << 16));
    const uint32_t lo = packed & 0xffffu, hi = packed >> 16;
    const uint32_t ref = formula_bf16_product(x, w);
    const bool ref_nan = (ref & 0x7fffu) > 0x7f80u;
    const bool lo_nan = (lo & 0x7fffu) > 0x7f80u;
    if (ref_nan && lo_nan && (hi & 0x7fffu) > 0x7f80u) {
      ++nans;
    } else if (lo != ref || hi != ref) {
      ++bad;
      atomicMin(first_bad, static_cast<unsigned long long>(p));
    }
  }
  if (bad) atomicAdd(mismatches, bad);
  if (nans) atomicAdd(nan_pairs, nans);
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a geometry the kernel was not built for.
// `w` is (capacity, heads) f32 in CSR order, or null (unweighted); with
// heads it must be 16 B aligned. `feats` is (n, ld) with ld >= f =
// heads * F, f32 or bf16 by `feats_bf16`; a bf16 table and any table with
// heads must have 16 B aligned rows (ld a multiple of 8 or 4, an aligned
// base). `out` is (n, f) f32 and `den`, unless null, (n, heads) f32 (it
// needs `w`), with the rows of split work items zeroed by the caller in
// both. `g` lanes take an edge and blockIdx.y walks tiles of `tile`
// columns: ops/spmm_kernels.k1_lanes.
extern "C" int stg_spmm_rowmask(const void* indptr, const void* cols,
                                const void* w, const void* feats,
                                int feats_bf16, const void* item_row,
                                const void* item_beg, int num_items,
                                void* out, void* den, int f, int ld, int heads,
                                int chunk, int g, int tile, void* stream) {
  Args a;
  a.indptr = static_cast<const int32_t*>(indptr);
  a.cols = static_cast<const int32_t*>(cols);
  a.w = static_cast<const float*>(w);
  a.feats = feats;
  a.item_row = static_cast<const int32_t*>(item_row);
  a.item_beg = static_cast<const int32_t*>(item_beg);
  a.out = static_cast<float*>(out);
  a.den = static_cast<float*>(den);
  a.num_items = num_items;
  a.f = f;
  a.ld = ld;
  a.heads = heads;
  a.chunk = chunk;
  a.tile = tile;
  a.stream = static_cast<cudaStream_t>(stream);
  if (heads < 1 || f < 1 || f % heads != 0 || tile < 1 || chunk < 1 ||
      (a.den != nullptr && a.w == nullptr) || (heads > 1 && a.w == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.grid = dim3((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock, (f + tile - 1) / tile);
  const int vcols = feats_bf16 ? 8 : 4;
  const bool aligned = ld % vcols == 0 && reinterpret_cast<uintptr_t>(feats) % 16 == 0;
  bool ok;
  if (heads > 1) {
    const bool w_aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0;
    ok = aligned && w_aligned && tile % vcols == 0 &&
         (feats_bf16 ? launch_heads<__nv_bfloat16>(a, g) : launch_heads<float>(a, g));
  } else if (feats_bf16) {
    ok = aligned && (a.w == nullptr ? launch_one_head<__nv_bfloat16, kNoWeight, false>(a, g)
                                    : launch_one_head<__nv_bfloat16, kShared, false>(a, g));
  } else if (aligned) {
    ok = a.w == nullptr ? launch_one_head<float, kNoWeight, false>(a, g)
                        : launch_one_head<float, kShared, false>(a, g);
  } else {
    ok = a.w == nullptr ? launch_one_head<float, kNoWeight, true>(a, g)
                        : launch_one_head<float, kShared, true>(a, g);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Holds the packed bf16 product (mul.rn.bf16x2, as K1 forms it) against the
// first design's round_to_bf16(__fmul_rn(x, w)) over the pairs
// [first, first + n) of all 2^32 (x, w) bit patterns, on `stream`. Writes
// the count of pairs that differ (NaN against NaN excepted), the count of
// NaN pairs and the first differing pair (2^64 - 1 if none) into the three
// u64 of `results`, which the caller zeroes but for the last (set to
// 2^64 - 1). Returns cudaGetLastError().
extern "C" int stg_bf16_product_check(unsigned long long first, unsigned long long n,
                                      void* results, void* stream) {
  auto* r = static_cast<unsigned long long*>(results);
  bf16_product_check_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      first, n, r, r + 1, r + 2);
  return static_cast<int>(cudaGetLastError());
}
