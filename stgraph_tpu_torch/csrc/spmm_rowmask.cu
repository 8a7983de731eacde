// K1 on Hopper: row-wise weighted SpMM over a CSR, for one head.
//
//   out[d, :] = sum_{e in [indptr[d], indptr[d+1])} w[e] * feats[cols[e], :]
//
// Replaces the TPU kernel segment_pallas._spmm_rowmask_kernel
// (stgraph_tpu/ops/segment_pallas.py:761, reached from spmm_rowmask at
// pallas_call :1083) on the forward SpMM of the GCN serving path.
//
// What bounds it on an H100: memory. It does 2 operations per gathered
// element, while the gather of feats[cols[e]] touches E * F elements spread
// over the whole table (at ogbn-products size the bf16 table is 627 MB,
// far above the 50 MB L2), so the time is set by how many random row reads
// the card keeps in flight. The compulsory bytes (cols, w, the table once,
// the output once) give a bound of about 1 ms at F = 128; the gathered
// traffic is about 25x that.
//
// What the design does about it:
//   - one warp per destination row (a "work item"), lanes across the
//     feature width, 128 columns per pass: a gathered row is read as one
//     coalesced 256 B (bf16) or 512 B (f32) transaction group;
//   - the warp loads 32 (col, w) pairs at once and broadcasts them with
//     shuffles, so the column stream is read once, coalesced;
//   - the gather happens inside the kernel: no (E, F) plane exists (the TPU
//     kernel needed an XLA pre-gather into one);
//   - in bf16-stream mode the wrapper casts the table to bf16 once (N x F),
//     halving the gathered bytes, with the row stride padded to a multiple
//     of 8 so 8-byte vector loads stay aligned at widths such as 47;
//   - a row with more than `chunk` edges is split into several work items
//     whose partial sums meet by atomicAdd in rows the wrapper zeroed, so a
//     power-law hub (about 10^6 in-edges on ogbn-products) does not leave
//     one warp running long after the rest.
//
// Rounding matches the TPU kernel: with a bf16 stream the gathered value
// and the weight are bf16, their product is rounded to bf16, and the sum is
// taken in f32; with an f32 stream every step is f32. Only the order of the
// f32 sums differs.
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

// kVec == 4: lane l owns columns 4l..4l+3 of the tile (needs ld % 4 == 0).
// kVec == 1: lane l owns columns l, l+32, l+64, l+96 (any width).
template <typename T, bool kWeighted, int kVec>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
spmm_rowmask_kernel(const int32_t* __restrict__ indptr,
                    const int32_t* __restrict__ cols,
                    const float* __restrict__ w,
                    const T* __restrict__ feats,
                    const int32_t* __restrict__ item_row,
                    const int32_t* __restrict__ item_beg,
                    float* __restrict__ out, int num_items, int f, int ld,
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

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int my_col = 0;
    float my_w = 0.f;
    if (e < end) {
      my_col = cols[e];
      if (kWeighted) my_w = stream_weight<T>(w[e]);
    }
    const int cnt = min(32, end - base);  // warp-uniform
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int src = __shfl_sync(0xffffffffu, my_col, j);
      const float wt = kWeighted ? __shfl_sync(0xffffffffu, my_w, j) : 1.f;
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
        acc[k] += kWeighted ? product<T>(v[k], wt) : v[k];
      }
    }
  }

  float* o = out + static_cast<int64_t>(row) * f + c0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = kVec == 4 ? lane * 4 + k : k * 32 + lane;
    if (c0 + c < f) {
      if (split) {
        atomicAdd(o + c, acc[k]);
      } else {
        o[c] = acc[k];
      }
    }
  }
}

template <typename T, bool kWeighted>
void launch(const int32_t* indptr, const int32_t* cols, const float* w,
            const T* feats, const int32_t* item_row, const int32_t* item_beg,
            float* out, int num_items, int f, int ld, int chunk,
            cudaStream_t stream) {
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (f + kTile - 1) / kTile);
  const dim3 block(kWarpsPerBlock * 32);
  const bool vec = ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(feats) % (4 * sizeof(T)) == 0;
  if (vec) {
    spmm_rowmask_kernel<T, kWeighted, 4><<<grid, block, 0, stream>>>(
        indptr, cols, w, feats, item_row, item_beg, out, num_items, f, ld,
        chunk);
  } else {
    spmm_rowmask_kernel<T, kWeighted, 1><<<grid, block, 0, stream>>>(
        indptr, cols, w, feats, item_row, item_beg, out, num_items, f, ld,
        chunk);
  }
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// `w` may be null (unweighted). `feats` is (n, ld) with ld >= f, f32 or
// bf16 by `feats_bf16`; `out` is (n, f) f32, with the rows of split work
// items zeroed by the caller.
extern "C" int stg_spmm_rowmask(const void* indptr, const void* cols,
                                const void* w, const void* feats,
                                int feats_bf16, const void* item_row,
                                const void* item_beg, int num_items,
                                void* out, int f, int ld, int chunk,
                                void* stream) {
  const auto* ip = static_cast<const int32_t*>(indptr);
  const auto* cl = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (feats_bf16) {
    const auto* x = static_cast<const __nv_bfloat16*>(feats);
    if (wt != nullptr) {
      launch<__nv_bfloat16, true>(ip, cl, wt, x, ir, ib, o, num_items, f, ld, chunk, s);
    } else {
      launch<__nv_bfloat16, false>(ip, cl, wt, x, ir, ib, o, num_items, f, ld, chunk, s);
    }
  } else {
    const auto* x = static_cast<const float*>(feats);
    if (wt != nullptr) {
      launch<float, true>(ip, cl, wt, x, ir, ib, o, num_items, f, ld, chunk, s);
    } else {
      launch<float, false>(ip, cl, wt, x, ir, ib, o, num_items, f, ld, chunk, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
