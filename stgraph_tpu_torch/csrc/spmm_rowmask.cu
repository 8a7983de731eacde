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
// 627 MB at F = 128, far above the 50 MB L2), so the time is set by how
// many random row reads the card keeps in flight. The compulsory bytes
// (cols, w, the table once, the output once) give a bound of about 1 ms at
// F = 128; the gathered traffic is about 25x that.
//
// What the design does about it:
//   - one warp per destination row (a "work item"), lanes across the
//     feature width, 128 columns per pass: a gathered row is read as one
//     coalesced 256 B (bf16) or 512 B (f32) transaction group;
//   - the warp loads 32 (col, w) pairs at once and broadcasts them with
//     shuffles, so the column stream is read once, coalesced;
//   - with several heads, an edge's H weights are one contiguous row of w.
//     A lane's 4 columns lie inside one head when F >= 4, so the lane loads
//     its head's weight once an edge (at 32 x 4 the warp reads the edge's
//     32 weights as one 128 B line); at F < 4 it loads one weight a column;
//   - the denominator sums the same weights in the same pass, unrounded:
//     the lane holding a head's first column adds each weight it loads
//     (one head: each lane adds the weights of the 32 edges it loaded, and
//     the warp sums them once per item). No second launch, no second walk;
//   - the gather happens inside the kernel: no (E, F) plane exists (the TPU
//     kernel needed an XLA pre-gather into one);
//   - in bf16-stream mode the wrapper casts the table to bf16 once (N x F),
//     halving the gathered bytes, with the row stride padded to a multiple
//     of 8 so 8-byte vector loads stay aligned at widths such as 47;
//   - a row with more than `chunk` edges is split into several work items
//     whose partial sums (and denominators) meet by atomicAdd in rows the
//     wrapper zeroed, so a power-law hub (about 10^6 in-edges on
//     ogbn-products) does not leave one warp running long after the rest.
//
// Rounding matches the TPU kernel (segment_pallas.py:860-906): with a bf16
// stream the gathered value and the weight are bf16, their product is
// rounded to bf16, and the sum is taken in f32; with an f32 stream every
// step is f32. The denominator sums the unrounded f32 weights in f32. Only
// the order of the f32 sums differs.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libspmm_rowmask-<hash>.so spmm_rowmask.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;  // feature columns one warp covers per pass

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

// The weight as the stream carries it.
template <typename T>
__device__ __forceinline__ float stream_weight(float w);
template <>
__device__ __forceinline__ float stream_weight<float>(float w) { return w; }
template <>
__device__ __forceinline__ float stream_weight<__nv_bfloat16>(float w) {
  return round_to_bf16(w);
}

// The per-edge product, formed in the stream's type.
template <typename T>
__device__ __forceinline__ float product(float x, float w);
template <>
__device__ __forceinline__ float product<float>(float x, float w) {
  return __fmul_rn(x, w);
}
template <>
__device__ __forceinline__ float product<__nv_bfloat16>(float x, float w) {
  return round_to_bf16(__fmul_rn(x, w));
}

// Column of the tile that lane `lane` holds in slot k.
// kVec == 4: columns 4l..4l+3 (needs ld % 4 == 0 and an aligned table).
// kVec == 1: columns l, l+32, l+64, l+96 (any width).
template <int kVec>
__device__ __forceinline__ int tile_col(int lane, int k) {
  return kVec == 4 ? lane * 4 + k : k * 32 + lane;
}

// How the weights reach a lane's columns.
constexpr int kNoWeight = 0;  // unweighted
constexpr int kShared = 1;    // one head: one weight an edge, shuffled
constexpr int kPerLane = 2;   // heads, F >= 4: a lane's 4 columns share a head
constexpr int kPerCol = 3;    // heads otherwise: the head of each column

template <typename T, int kW, int kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_rowmask_kernel(const int32_t* __restrict__ indptr,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ w,
                    const T* __restrict__ feats,
                    const int32_t* __restrict__ item_row,
                    const int32_t* __restrict__ item_beg,
                    float* __restrict__ out, float* __restrict__ den,
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
  const int c0 = blockIdx.y * kTile;
  const bool want_den = den != nullptr;

  // The head of each of this lane's columns, and which of them open a head:
  // the lane holding a head's first column sums its denominator.
  int head[4];
  bool opens[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = c0 + tile_col<kVec>(lane, k);
    head[k] = min(c, f - 1) / head_f;
    opens[k] = want_den && c < f && c % head_f == 0;
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float dacc[4] = {0.f, 0.f, 0.f, 0.f};  // denominator partials (heads)
  float dsum = 0.f;                      // denominator partial (one head)
  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int my_col = 0;
    float my_w = 0.f;
    if (e < end) {
      my_col = cols[e];
      if (kW == kShared) {
        const float raw = w[e];
        dsum += raw;
        my_w = stream_weight<T>(raw);
      }
    }
    const int cnt = min(32, end - base);  // warp-uniform
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int src = __shfl_sync(0xffffffffu, my_col, j);
      float wt[4] = {1.f, 1.f, 1.f, 1.f};
      if (kW == kShared) {
        wt[0] = wt[1] = wt[2] = wt[3] = __shfl_sync(0xffffffffu, my_w, j);
      } else if (kW == kPerLane) {
        const float raw = __ldg(w + static_cast<int64_t>(base + j) * heads + head[0]);
        if (opens[0]) dacc[0] += raw;
        wt[0] = wt[1] = wt[2] = wt[3] = stream_weight<T>(raw);
      } else if (kW == kPerCol) {
        const float* wr = w + static_cast<int64_t>(base + j) * heads;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float raw = __ldg(wr + head[k]);
          if (opens[k]) dacc[k] += raw;
          wt[k] = stream_weight<T>(raw);
        }
      }
      const T* p = feats + static_cast<int64_t>(src) * ld + c0;
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
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[k] += kW == kNoWeight ? v[k] : product<T>(v[k], wt[k]);
      }
    }
  }

  float* o = out + static_cast<int64_t>(row) * f + c0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = tile_col<kVec>(lane, k);
    if (c0 + c < f) {
      if (split) {
        atomicAdd(o + c, acc[k]);
      } else {
        o[c] = acc[k];
      }
    }
  }
  if (!want_den) return;
  float* d = den + static_cast<int64_t>(row) * heads;
  if (kW == kShared) {
    // each lane summed the weights of the edges it loaded
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, s);
    if (lane == 0 && blockIdx.y == 0) {
      if (split) {
        atomicAdd(d, dsum);
      } else {
        *d = dsum;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (opens[k]) {
        if (split) {
          atomicAdd(d + head[k], dacc[k]);
        } else {
          d[head[k]] = dacc[k];
        }
      }
    }
  }
}

template <typename T, int kW>
void launch(const int32_t* indptr, const int32_t* cols, const float* w,
            const T* feats, const int32_t* item_row, const int32_t* item_beg,
            float* out, float* den, int num_items, int f, int ld, int heads,
            int chunk, bool vec, cudaStream_t stream) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (f + kTile - 1) / kTile);
  const dim3 block(kWarpsPerBlock * 32);
  const int head_f = f / heads;
  if (vec) {
    spmm_rowmask_kernel<T, kW, 4><<<grid, block, 0, stream>>>(
        indptr, cols, w, feats, item_row, item_beg, out, den, num_items, f,
        ld, heads, head_f, chunk);
  } else {
    spmm_rowmask_kernel<T, kW, 1><<<grid, block, 0, stream>>>(
        indptr, cols, w, feats, item_row, item_beg, out, den, num_items, f,
        ld, heads, head_f, chunk);
  }
}

template <typename T>
void launch_weights(const int32_t* indptr, const int32_t* cols, const float* w,
                    const T* feats, const int32_t* item_row,
                    const int32_t* item_beg, float* out, float* den,
                    int num_items, int f, int ld, int heads, int chunk,
                    cudaStream_t stream) {
  const bool vec = ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % (4 * sizeof(T)) == 0;
  if (w == nullptr) {
    launch<T, kNoWeight>(indptr, cols, w, feats, item_row, item_beg, out, den,
                         num_items, f, ld, heads, chunk, vec, stream);
  } else if (heads == 1) {
    launch<T, kShared>(indptr, cols, w, feats, item_row, item_beg, out, den,
                       num_items, f, ld, heads, chunk, vec, stream);
  } else if (vec && (f / heads) % 4 == 0) {
    launch<T, kPerLane>(indptr, cols, w, feats, item_row, item_beg, out, den,
                        num_items, f, ld, heads, chunk, vec, stream);
  } else {
    launch<T, kPerCol>(indptr, cols, w, feats, item_row, item_beg, out, den,
                       num_items, f, ld, heads, chunk, vec, stream);
  }
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// `w` is (capacity, heads) f32 in CSR order, or null (unweighted). `feats`
// is (n, ld) with ld >= f = heads * F, f32 or bf16 by `feats_bf16`; `out`
// is (n, f) f32 and `den`, unless null, (n, heads) f32 (it needs `w`), with
// the rows of split work items zeroed by the caller in both.
extern "C" int stg_spmm_rowmask(const void* indptr, const void* cols,
                                const void* w, const void* feats,
                                int feats_bf16, const void* item_row,
                                const void* item_beg, int num_items,
                                void* out, void* den, int f, int ld, int heads,
                                int chunk, void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* cl = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto* d = static_cast<float*>(den);
  auto s = static_cast<cudaStream_t>(stream);
  if (heads < 1 || f % heads != 0 || (d != nullptr && wt == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (feats_bf16) {
    launch_weights<__nv_bfloat16>(ip, cl, wt,
                                  static_cast<const __nv_bfloat16*>(feats), ir,
                                  ib, o, d, num_items, f, ld, heads, chunk, s);
  } else {
    launch_weights<float>(ip, cl, wt, static_cast<const float*>(feats), ir, ib,
                          o, d, num_items, f, ld, heads, chunk, s);
  }
  return static_cast<int>(cudaGetLastError());
}
