// Probes of K8's and K9's first design, for benchmarking/micro/k8_k9_bench.py:
// each kernel with its two phases apart, to time them alone on the card. It
// is not part of the port and no path calls it.
//
// The first design (stgraph_tpu_torch/csrc/flash_gat_{fwd,bwd}.cu before
// their redesign): one warp a work item, lanes across the row's columns.
// Per 32 edges the warp first forms the 32 x H weights (lane l: head
// l % KH of edges l / KH + t * 32 / KH, from el[src] or the destination
// fields), writes them to a shared-memory table and syncs, and only then
// walks the 32 rows (`#pragma unroll 4`). Only its bf16 one-head vector
// tiles are here (8 x 32 and 1 x 47 with a bf16 stream), without dropout:
//
//   kPhase 0: the whole kernel (as the first design; a check of the copy);
//   kPhase 1: the weight phase alone: the weights formed, den and p (K8) or
//             dl's c term (K9) written, no row gathered (out, u, dfs = 0);
//   kPhase 2: the row walk alone: the weight table filled once with 1, no
//             el or fields read, every row gathered and multiplied.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libk8_k9_parts.so k8_k9_parts.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ __nv_bfloat162 as_bf16x2(uint32_t x) {
  __nv_bfloat162 v;
  *reinterpret_cast<uint32_t*>(&v) = x;
  return v;
}

__device__ __forceinline__ void madd_bf16x2(uint32_t x, float w_lo, float w_hi, float& acc_lo, float& acc_hi) {
  const __nv_bfloat162 r = __hmul2(as_bf16x2(x), __floats2bfloat162_rn(w_lo, w_hi));
  acc_lo += __low2float(r);
  acc_hi += __high2float(r);
}

template <int kSlots>
__device__ __forceinline__ void load_packed(const __nv_bfloat16* p, int lane, int ld, uint32_t raw[kSlots / 2]) {
  const int c = lane * kSlots;
  if (c < ld) {
    if (kSlots == 8) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p + c));
      raw[0] = x.x;
      raw[1] = x.y;
      raw[2] = x.z;
      raw[3] = x.w;
    } else {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p + c));
      raw[0] = x.x;
      raw[1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSlots / 2; ++q) raw[q] = 0u;
  }
}

template <int kKH, int kSlots, bool kAux, int kPhase>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
k8_probe_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
                const float* __restrict__ el, const float* __restrict__ er, const float* __restrict__ m,
                const __nv_bfloat16* __restrict__ fs, const int32_t* __restrict__ item_row,
                const int32_t* __restrict__ item_beg, int num_items, float* __restrict__ out,
                float* __restrict__ den, float* __restrict__ u, float* __restrict__ p, int h, int f, int hf,
                int ld, float slope, int chunk) {
  constexpr int kStride = 32 / kKH;
  __shared__ float sw[kWarpsPerBlock][32][kKH];
  __shared__ float swl[kWarpsPerBlock][32][kAux ? kKH : 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + warp;
  if (item >= num_items) return;
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  const int64_t rh = static_cast<int64_t>(row) * h;
  const int64_t rc = static_cast<int64_t>(row) * hf;
  const int wh = lane % kKH;
  const int wsub = lane / kKH;
  const bool wh_ok = wh < h;
  const float er_d = wh_ok ? __ldg(er + rh + wh) : 0.f;
  const float m_d = wh_ok ? __ldg(m + rh + wh) : 0.f;
  float den_l = 0.f, p_l = 0.f;
  const int hs0 = min(lane * kSlots, hf - 1) / f;
  float acc[kSlots], uacc[kAux ? kSlots : 1];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
#pragma unroll
  for (int s = 0; s < (kAux ? kSlots : 1); ++s) uacc[s] = 0.f;
  if (kPhase == 2) {  // a constant weight table
#pragma unroll
    for (int t = 0; t < kKH; ++t) {
      sw[warp][lane][t] = 1.f;
      if (kAux) swl[warp][lane][t] = 1.f;
    }
    __syncwarp();
  }

  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_src = lane < cnt ? cols[base + lane] : 0;
    if (kPhase != 2) {
#pragma unroll
      for (int t = 0; t < kKH; ++t) {
        const int j = wsub + t * kStride;
        const int src = __shfl_sync(kFull, my_src, j);
        if (wh_ok && j < cnt) {
          const float s0 = __ldg(el + static_cast<int64_t>(src) * h + wh) + er_d;
          const float lk = s0 >= 0.f ? s0 : slope * s0;
          const float w = expf(fminf(lk - m_d, 0.f));
          den_l += w;
          sw[warp][j][wh] = round_to_bf16(w);
          if (kAux) {
            const float wl = w * (s0 >= 0.f ? 1.f : slope);
            p_l += wl;
            swl[warp][j][wh] = round_to_bf16(wl);
          }
        }
      }
      __syncwarp();
    }
    if (kPhase != 1) {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int src = __shfl_sync(kFull, my_src, j);
        const __nv_bfloat16* row_p = fs + static_cast<int64_t>(src) * ld;
        const float w = sw[warp][j][hs0];
        const float wl = kAux ? swl[warp][j][hs0] : 0.f;
        uint32_t raw[kSlots / 2];
        load_packed<kSlots>(row_p, lane, ld, raw);
#pragma unroll
        for (int q = 0; q < kSlots / 2; ++q) {
          madd_bf16x2(raw[q], w, w, acc[2 * q], acc[2 * q + 1]);
          if (kAux) madd_bf16x2(raw[q], wl, wl, uacc[2 * q], uacc[2 * q + 1]);
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int o = kKH; o < 32; o <<= 1) {
    den_l += __shfl_xor_sync(kFull, den_l, o);
    if (kAux) p_l += __shfl_xor_sync(kFull, p_l, o);
  }
  if (lane < h) {
    if (split) {
      atomicAdd(den + rh + lane, den_l);
      if (kAux) atomicAdd(p + rh + lane, p_l);
    } else {
      den[rh + lane] = den_l;
      if (kAux) p[rh + lane] = p_l;
    }
  }
  const float dn = __shfl_sync(kFull, den_l, hs0);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane * kSlots + s;
    if (c < hf) {
      if (split) {
        atomicAdd(out + rc + c, acc[s]);
        if (kAux) atomicAdd(u + rc + c, uacc[s]);
      } else {
        out[rc + c] = acc[s] / fmaxf(dn, FLT_MIN);
        if (kAux) u[rc + c] = uacc[s];
      }
    }
  }
}

template <int kKH, int kSlots, int kPhase>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
k9_probe_kernel(const int32_t* __restrict__ indptr, const int32_t* __restrict__ cols,
                const float* __restrict__ el, const float* __restrict__ fields,
                const __nv_bfloat16* __restrict__ gu, const float* __restrict__ fs,
                const int32_t* __restrict__ item_row, const int32_t* __restrict__ item_beg, int num_items,
                float* __restrict__ dfs, float* __restrict__ dl, int h, int f, int hf, int ld, float slope,
                int chunk) {
  constexpr int kStride = 32 / kKH;
  __shared__ float sw[kWarpsPerBlock][32][kKH];
  __shared__ float sa[kWarpsPerBlock][32][kKH];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + warp;
  if (item >= num_items) return;
  const int row = item_row[item];
  const int row_beg = indptr[row];
  const int row_end = indptr[row + 1];
  const int beg = item_beg[item];
  const int end = min(beg + chunk, row_end);
  const bool split = row_end - row_beg > chunk;
  const int64_t rh = static_cast<int64_t>(row) * h;
  const int64_t rc = static_cast<int64_t>(row) * hf;
  const int wh = lane % kKH;
  const int wsub = lane / kKH;
  const bool wh_ok = wh < h;
  const float el_s = wh_ok ? __ldg(el + rh + wh) : 0.f;
  float cterm = 0.f;
  int hs[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) hs[s] = min(lane * kSlots + s, hf - 1) / f;
  uint32_t xp[kSlots / 2];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane * kSlots + s;
    const float v = c < hf ? round_to_bf16(__ldg(fs + rc + c)) : 0.f;
    if (s % 2 == 0) {
      xp[s / 2] = static_cast<uint32_t>(__float_as_uint(v) >> 16);
    } else {
      xp[s / 2] |= __float_as_uint(v) & 0xffff0000u;
    }
  }
  float acc[kSlots], dla[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) acc[s] = dla[s] = 0.f;
  if (kPhase == 2) {
#pragma unroll
    for (int t = 0; t < kKH; ++t) sw[warp][lane][t] = sa[warp][lane][t] = 1.f;
    __syncwarp();
  }

  for (int base = beg; base < end; base += 32) {
    const int cnt = min(32, end - base);
    const int my_dst = lane < cnt ? cols[base + lane] : 0;
    if (kPhase != 2) {
#pragma unroll
      for (int t = 0; t < kKH; ++t) {
        const int j = wsub + t * kStride;
        const int dst = __shfl_sync(kFull, my_dst, j);
        if (wh_ok && j < cnt) {
          const float* fd = fields + static_cast<int64_t>(dst) * 3 * h;
          const float s0 = el_s + __ldg(fd + wh);
          const float lk = s0 >= 0.f ? s0 : slope * s0;
          const float w = expf(fminf(lk - __ldg(fd + h + wh), 0.f));
          const float a = w * (s0 >= 0.f ? 1.f : slope);
          sw[warp][j][wh] = round_to_bf16(w);
          sa[warp][j][wh] = a;
          cterm += a * __ldg(fd + 2 * h + wh);
        }
      }
      __syncwarp();
    }
    if (kPhase != 1) {
#pragma unroll 4
      for (int j = 0; j < cnt; ++j) {
        const int dst = __shfl_sync(kFull, my_dst, j);
        const __nv_bfloat16* row_p = gu + static_cast<int64_t>(dst) * ld;
        const float w = sw[warp][j][hs[0]];
        const float a = sa[warp][j][hs[0]];
        uint32_t raw[kSlots / 2];
        load_packed<kSlots>(row_p, lane, ld, raw);
#pragma unroll
        for (int q = 0; q < kSlots / 2; ++q) {
          const __nv_bfloat162 g2 = as_bf16x2(raw[q]);
          const __nv_bfloat162 r = __hmul2(g2, __floats2bfloat162_rn(w, w));
          acc[2 * q] += __low2float(r);
          acc[2 * q + 1] += __high2float(r);
          const __nv_bfloat162 d = __hmul2(as_bf16x2(xp[q]), g2);
          dla[2 * q] = fmaf(a, __low2float(d), dla[2 * q]);
          dla[2 * q + 1] = fmaf(a, __high2float(d), dla[2 * q + 1]);
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int c = lane * kSlots + s;
    if (c < hf) {
      if (split) {
        atomicAdd(dfs + rc + c, acc[s]);
      } else {
        dfs[rc + c] = acc[s];
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < kKH; ++hh) {
    if (hh < h) {
      float t = wh == hh ? -cterm : 0.f;
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        if (hs[s] == hh) t += dla[s];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
      if (lane == 0) {
        if (split) {
          atomicAdd(dl + rh + hh, t);
        } else {
          dl[rh + hh] = t;
        }
      }
    }
  }
}

#define STG_GRID(n) dim3(((n) + kWarpsPerBlock - 1) / kWarpsPerBlock), dim3(kWarpsPerBlock * 32), 0, st

template <int kKH, int kSlots, bool kAux>
void k8_launch(int phase, cudaStream_t st, const int32_t* indptr, const int32_t* cols, const float* el,
               const float* er, const float* m, const __nv_bfloat16* fs, const int32_t* item_row,
               const int32_t* item_beg, int num_items, float* out, float* den, float* u, float* p, int h, int f,
               int ld, float slope, int chunk) {
#define STG_K8(ph)                                                                                      \
  k8_probe_kernel<kKH, kSlots, kAux, ph><<<STG_GRID(num_items)>>>(indptr, cols, el, er, m, fs, item_row, \
                                                                 item_beg, num_items, out, den, u, p, h, \
                                                                 f, h * f, ld, slope, chunk)
  if (phase == 0) STG_K8(0);
  else if (phase == 1) STG_K8(1);
  else STG_K8(2);
#undef STG_K8
}

template <int kKH, int kSlots>
void k9_launch(int phase, cudaStream_t st, const int32_t* indptr, const int32_t* cols, const float* el,
               const float* fields, const __nv_bfloat16* gu, const float* fs, const int32_t* item_row,
               const int32_t* item_beg, int num_items, float* dfs, float* dl, int h, int f, int ld, float slope,
               int chunk) {
#define STG_K9(ph)                                                                                            \
  k9_probe_kernel<kKH, kSlots, ph><<<STG_GRID(num_items)>>>(indptr, cols, el, fields, gu, fs, item_row,      \
                                                           item_beg, num_items, dfs, dl, h, f, h * f, ld,    \
                                                           slope, chunk)
  if (phase == 0) STG_K9(0);
  else if (phase == 1) STG_K9(1);
  else STG_K9(2);
#undef STG_K9
}

// The tilings the probes hold: 8 x 32 (KH 8, 8 columns a lane) and 1 x 47
// (KH 1, 4 columns a lane), a bf16 table with 16 B aligned rows.
bool probe_tiling(int h, int f, int ld, const void* table) {
  return ((h == 8 && f == 32) || (h == 1 && f == 47)) && ld % 8 == 0 &&
         reinterpret_cast<uintptr_t>(table) % 16 == 0;
}

}  // namespace

// K8's first design with its phases apart (`phase` 0, 1, 2 as kPhase above),
// bf16 table `fs` (n, ld); `u` and `p` null without aux. The caller zeroes
// the rows of split items. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tiling the probe does not hold.
extern "C" int stg_k8_probe(const void* indptr, const void* cols, const void* el, const void* er, const void* m,
                            const void* fs, const void* item_row, const void* item_beg, int num_items, void* out,
                            void* den, void* u, void* p, int h, int f, int ld, float slope, int chunk, int phase,
                            void* stream) {
  if (!probe_tiling(h, f, ld, fs)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const auto* a_indptr = static_cast<const int32_t*>(indptr);
  const auto* a_cols = static_cast<const int32_t*>(cols);
  const auto* a_el = static_cast<const float*>(el);
  const auto* a_er = static_cast<const float*>(er);
  const auto* a_m = static_cast<const float*>(m);
  const auto* a_fs = static_cast<const __nv_bfloat16*>(fs);
  const auto* a_row = static_cast<const int32_t*>(item_row);
  const auto* a_beg = static_cast<const int32_t*>(item_beg);
  auto* a_out = static_cast<float*>(out);
  auto* a_den = static_cast<float*>(den);
  auto* a_u = static_cast<float*>(u);
  auto* a_p = static_cast<float*>(p);
#define STG_ARGS a_indptr, a_cols, a_el, a_er, a_m, a_fs, a_row, a_beg, num_items, a_out, a_den, a_u, a_p, h, f, ld, \
                 slope, chunk
  if (h == 8) {
    if (u != nullptr) k8_launch<8, 8, true>(phase, st, STG_ARGS);
    else k8_launch<8, 8, false>(phase, st, STG_ARGS);
  } else {
    if (u != nullptr) k8_launch<1, 4, true>(phase, st, STG_ARGS);
    else k8_launch<1, 4, false>(phase, st, STG_ARGS);
  }
#undef STG_ARGS
  return static_cast<int>(cudaGetLastError());
}

// K9's first design with its phases apart: the transpose CSR, `fields`
// (n, 3h) [er | m | c], bf16 table `gu` (n, ld), f32 `fs` (n, h f). The
// caller zeroes the rows of split items in dfs and dl.
extern "C" int stg_k9_probe(const void* indptr, const void* cols, const void* el, const void* fields, const void* gu,
                            const void* fs, const void* item_row, const void* item_beg, int num_items, void* dfs,
                            void* dl, int h, int f, int ld, float slope, int chunk, int phase, void* stream) {
  if (!probe_tiling(h, f, ld, gu)) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define STG_ARGS static_cast<const int32_t*>(indptr), static_cast<const int32_t*>(cols), \
                 static_cast<const float*>(el), static_cast<const float*>(fields),       \
                 static_cast<const __nv_bfloat16*>(gu), static_cast<const float*>(fs),   \
                 static_cast<const int32_t*>(item_row), static_cast<const int32_t*>(item_beg), num_items, \
                 static_cast<float*>(dfs), static_cast<float*>(dl), h, f, ld, slope, chunk
  if (h == 8) k9_launch<8, 8>(phase, st, STG_ARGS);
  else k9_launch<1, 4>(phase, st, STG_ARGS);
#undef STG_ARGS
  return static_cast<int>(cudaGetLastError());
}
