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
// ogbn-products size and F = 128; the gathered traffic is about 6x that,
// so, as for K1, the time is set by how many random row reads the card
// keeps in flight.
//
// What the design does about it:
//   - one warp per transpose row (a "work item"), lanes across the features,
//     as K1: a gathered g row is one coalesced 256 B (bf16) or 512 B (f32)
//     transaction group, and the same gather feeds both dh and dw (the TPU
//     kernel folds the SDDMM into its transpose pass for the same reason);
//   - fs[s] is row-local: the warp reads its tile once per item into
//     registers, so the SDDMM adds no gather;
//   - one head: per edge, each lane forms the partial dot product of its
//     columns and the warp sums the partials with __shfl_xor_sync; the lane
//     that loaded the edge keeps the sum and the 32 lanes store 32
//     consecutive dw values at once. F > 128: the warp walks the 128-column
//     tiles itself, in an outer loop, and adds each tile's partial into
//     dw[e]; the lane that owns an edge is the same in every tile, so the
//     read-modify-write needs no atomics;
//   - several heads (128 % F == 0 and (H * F) % 128 == 0, so every head lies
//     inside one tile and a lane's 4 columns inside one head when F >= 4):
//     a lane loads its head's weight once an edge (one a column at F < 4);
//     per edge the F / 4 lanes of a head sum their partial dots by
//     log2(F / 4) shuffles and the head's first lane stores dw[e, h] (at
//     32 x 4 no shuffle at all: a lane is a head, and the warp stores the
//     edge's 32 dw values as one 128 B line); at F < 4 a lane's 4 columns
//     hold 4 / F whole heads, whose dots it forms and stores itself;
//   - a row with more than `chunk` edges (the synthetic ogbn-products graph
//     draws sources and destinations from one Chung-Lu profile, so the
//     transpose has an out-degree hub of about 10^6 edges) is split into
//     work items whose dh partials meet by atomicAdd in rows the wrapper
//     zeroed. dw[e, :] belongs to exactly one item: a plain store.
//   - in bf16-stream mode the wrapper casts g to a bf16 table once (row
//     stride padded to a multiple of 8, as K1); fs stays f32 and is rounded
//     to bf16 as it is read, which saves a cast pass over it.
//
// Rounding matches the TPU kernel (segment_pallas.py:1380-1414): with a
// bf16 stream, dh's product of the bf16 weight and the bf16 g value is
// rounded to bf16 and summed in f32, and dw's elementwise products of the
// bf16 fs and g values are rounded to bf16 and summed over the head's
// features in f32; with an f32 stream every step is f32. Only the order of
// f32 sums differs.
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
constexpr int kTile = 128;  // feature columns one warp covers per pass
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return bf16_bits_to_float(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Four consecutive elements: one 16 B (f32) or 8 B (bf16) load.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = bf16_bits_to_float(q.x & 0xffffu);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = bf16_bits_to_float(q.y & 0xffffu);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An f32 value (a weight, an fs element) as the stream carries it.
template <typename T>
__device__ __forceinline__ float stream_value(float x);
template <>
__device__ __forceinline__ float stream_value<float>(float x) { return x; }
template <>
__device__ __forceinline__ float stream_value<__nv_bfloat16>(float x) {
  return round_to_bf16(x);
}

// A product of two stream values, formed in the stream's type.
template <typename T>
__device__ __forceinline__ float product(float a, float b);
template <>
__device__ __forceinline__ float product<float>(float a, float b) {
  return __fmul_rn(a, b);
}
template <>
__device__ __forceinline__ float product<__nv_bfloat16>(float a, float b) {
  return round_to_bf16(__fmul_rn(a, b));
}

// Column of the tile that lane `lane` holds in slot k.
// kVec == 4: columns 4l..4l+3 (needs ld % 4 == 0 and an aligned table).
// kVec == 1: columns l, l+32, l+64, l+96 (any width).
template <int kVec>
__device__ __forceinline__ int tile_col(int lane, int k) {
  return kVec == 4 ? lane * 4 + k : k * 32 + lane;
}

// How dw is formed (see the header): one head over the whole warp, or
// several heads with F >= 4 over groups of F / 4 lanes, or F < 4 inside a
// lane.
constexpr int kOneHead = 0;
constexpr int kLaneGroups = 1;
constexpr int kInLane = 2;

template <typename T, int kVec, int kMode>
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
  const float* fs_row = fs + static_cast<int64_t>(row) * f;
  float* dh_row = dh + static_cast<int64_t>(row) * f;
  // heads: the lanes of one head form a group of `group` lanes (F / 4, a
  // power of two, as 128 % F == 0)
  const int group = kMode == kLaneGroups ? head_f / 4 : 1;

  for (int c0 = 0; c0 < f; c0 += kTile) {
    float x[4];  // fs[row] on this lane's columns of the tile
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + tile_col<kVec>(lane, k);
      x[k] = c < f ? stream_value<T>(__ldg(fs_row + c)) : 0.f;
    }
    // the head of this lane's first column (heads: every column of the tile
    // is real, as H * F % 128 == 0)
    const int head0 = (c0 + tile_col<kVec>(lane, 0)) / head_f;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      int my_col = 0;
      float my_w = 0.f;
      if (e < end) {
        my_col = cols[e];
        if (kMode == kOneHead) my_w = stream_value<T>(w[e]);
      }
      float my_dw = 0.f;  // one head: the dot product of the edge this lane loaded
      const int cnt = min(32, end - base);  // warp-uniform
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int dst = __shfl_sync(kFull, my_col, j);
        const int64_t ej = base + j;
        float wt[4];
        if (kMode == kOneHead) {
          wt[0] = wt[1] = wt[2] = wt[3] = __shfl_sync(kFull, my_w, j);
        } else if (kMode == kLaneGroups) {
          wt[0] = wt[1] = wt[2] = wt[3] = stream_value<T>(__ldg(w + ej * heads + head0));
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            wt[k] = stream_value<T>(__ldg(w + ej * heads + head0 + k / head_f));
          }
        }
        const T* p = g + static_cast<int64_t>(dst) * ld + c0;
        float v[4];
        if (kVec == 4) {
          const int c = lane * 4;
          if (c0 + c < ld) {
            load4(p + c, v);
          } else {
            v[0] = v[1] = v[2] = v[3] = 0.f;
          }
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int c = k * 32 + lane;
            v[k] = (c0 + c < f) ? load1(p + c) : 0.f;
          }
        }
        float part[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k] += product<T>(v[k], wt[k]);
          part[k] = product<T>(x[k], v[k]);
        }
        if (kMode == kInLane) {
          // F = 1 or 2: this lane's 4 columns are 4 / F whole heads
          float* d = dw + ej * heads + head0;
          if (head_f == 1) {
#pragma unroll
            for (int k = 0; k < 4; ++k) d[k] = part[k];
          } else {
            d[0] = part[0] + part[1];
            d[1] = part[2] + part[3];
          }
        } else {
          float dot = (part[0] + part[1]) + (part[2] + part[3]);
          for (int s = (kMode == kOneHead ? 32 : group) >> 1; s > 0; s >>= 1) {
            dot += __shfl_xor_sync(kFull, dot, s);
          }
          if (kMode == kOneHead) {
            if (lane == j) my_dw = dot;
          } else if ((lane & (group - 1)) == 0) {
            dw[ej * heads + head0] = dot;
          }
        }
      }
      // one head: the F > 128 tiles add into the dot of the first; the lane
      // that owns an edge is the same in every tile, so no atomics
      if (kMode == kOneHead && e < end) dw[e] = c0 == 0 ? my_dw : dw[e] + my_dw;
    }

#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + tile_col<kVec>(lane, k);
      if (c < f) {
        if (split) {
          atomicAdd(dh_row + c, acc[k]);
        } else {
          dh_row[c] = acc[k];
        }
      }
    }
  }
}

template <typename T, int kMode>
void launch(const int32_t* indptr, const int32_t* cols, const float* w,
            const T* g, const float* fs, const int32_t* item_row,
            const int32_t* item_beg, float* dh, float* dw, int num_items,
            int f, int ld, int heads, int chunk, bool vec,
            cudaStream_t stream) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const int head_f = f / heads;
  if (vec) {
    spmm_sddmm_rowmask_kernel<T, 4, kMode><<<grid, block, 0, stream>>>(
        indptr, cols, w, g, fs, item_row, item_beg, dh, dw, num_items, f, ld,
        heads, head_f, chunk);
  } else if (kMode == kOneHead) {
    spmm_sddmm_rowmask_kernel<T, 1, kOneHead><<<grid, block, 0, stream>>>(
        indptr, cols, w, g, fs, item_row, item_beg, dh, dw, num_items, f, ld,
        heads, head_f, chunk);
  }
}

// The modes for `heads`, or -1 when the tiling is not one K2 takes: several
// heads need 128 % F == 0, (H * F) % 128 == 0 and 4-column lanes (vec).
template <typename T>
int launch_heads(const int32_t* indptr, const int32_t* cols, const float* w,
                 const T* g, const float* fs, const int32_t* item_row,
                 const int32_t* item_beg, float* dh, float* dw, int num_items,
                 int f, int ld, int heads, int chunk, cudaStream_t stream) {
  const bool vec = ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
  if (heads < 1 || f % heads != 0) return -1;
  if (heads == 1) {
    launch<T, kOneHead>(indptr, cols, w, g, fs, item_row, item_beg, dh, dw,
                        num_items, f, ld, heads, chunk, vec, stream);
    return 0;
  }
  const int head_f = f / heads;
  if (head_f < 1 || kTile % head_f != 0 || f % kTile != 0 || !vec) return -1;
  if (head_f >= 4) {
    launch<T, kLaneGroups>(indptr, cols, w, g, fs, item_row, item_beg, dh, dw,
                           num_items, f, ld, heads, chunk, vec, stream);
  } else {
    launch<T, kInLane>(indptr, cols, w, g, fs, item_row, item_beg, dh, dw,
                       num_items, f, ld, heads, chunk, vec, stream);
  }
  return 0;
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// `g` is (n, ld) with ld >= f = heads * F, f32 or bf16 by `g_bf16`; `fs` is
// (n, f) f32; `w` and `dw` are (capacity, heads) f32 in this CSR's edge
// order; `dh` is (n, f) f32. The caller zeroes the dh rows of split work
// items and the padding slots of dw; the kernel writes every other element
// of both.
extern "C" int stg_spmm_sddmm_rowmask(const void* indptr, const void* cols,
                                      const void* w, const void* g, int g_bf16,
                                      const void* fs, const void* item_row,
                                      const void* item_beg, int num_items,
                                      void* dh, void* dw, int f, int ld,
                                      int heads, int chunk, void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* cl = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* x = static_cast<const float*>(fs);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(dh);
  auto* d = static_cast<float*>(dw);
  auto s = static_cast<cudaStream_t>(stream);
  const int rc =
      g_bf16 ? launch_heads<__nv_bfloat16>(ip, cl, wt, static_cast<const __nv_bfloat16*>(g), x,
                                           ir, ib, o, d, num_items, f, ld, heads, chunk, s)
             : launch_heads<float>(ip, cl, wt, static_cast<const float*>(g), x, ir, ib, o, d,
                                   num_items, f, ld, heads, chunk, s);
  if (rc != 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
