// K10 on Hopper: the multi-head weighted segment sum over the blocked layout.
//
//   out[d, c] = sum_{slots s with dst[s] == d} w[s, c / F] * feats[cols[s], c]
//
// for c < H * F, over the blocked layout of graph/blocked.py: row blocks of
// 128 destinations, each block's slots in CSR order and padded with sentinel
// slots to a multiple of 1024. `w` is the weights head-major, (H, CB) f32
// in slot order, `feats` the (n, H * F) f32 node table, `out` (n, H * F)
// f32.
//
// Replaces the TPU kernel spmm_pallas._seg_matmul_kernel
// (stgraph_tpu/ops/spmm_pallas.py:61, reached from segment_sum_blocked at
// pallas_call :196) on the composed GAT route: the forward's weighted
// aggregation, and d feat on the transpose layout in backward, for the head
// tilings the row-wise kernel's multi-head mode does not take (the GAT
// paper's PPI widths, 4 x 256 and 6 x 121). The TPU kernel multiplied a 0/1
// selection matrix into rows that XLA had gathered before it; here the
// gather is inside the kernel: at ogbn-products size and H * F = 1024 the
// gathered rows would be a 507 GB intermediate.
//
// What bounds it on an H100: memory. Two operations per gathered element.
// The compulsory bytes (the slot indices and weights, the table once, the
// output once) give about 7 ms at ogbn-products size and H * F = 1024, but
// each slot gathers a whole row: 25 times the table at that size. So the
// time is set by where the gathered rows come from. At PPI size the (N, 1024)
// table is 233 MB, five times the 50 MB L2, but a 128-column slice of it
// (29 MB) fits; at ogbn-products size nothing does, and L2 holds only the
// hot rows, more of them the narrower the slice.
//
// What the design does about it (K1's row-wise design over the layout's
// real slots):
//   - the work is a host-built list of items (ops/spmm_blocked.py,
//     k10_work_items): a row's slots are contiguous in the layout, so an
//     item is a slot range of one row, at most K10_CHUNK long; a longer row
//     is split into several items, and an empty row has an empty item. The
//     layout's sentinel slots are never visited and `dst` is never read;
//   - one warp an item holds a panel of at most 128 columns of one head in
//     registers, lanes across the columns in pieces of 32 * V (V = 4, 2 or
//     1 columns a lane, one 16, 8 or 4 B load), and blockIdx.y walks the
//     heads' panels, so the whole grid gathers one panel's slice of the
//     table before the next; that slice stays in L2 at PPI size. A slot
//     needs one weight a panel, read for 32 slots at once from the
//     head-major weights (a (CB, H) read would bring every head's weights
//     into L2 with each panel and evict the slice). Where F % V != 0 (121,
//     47) the panel starts at the head's first column rounded down to V,
//     so the loads stay aligned, and a lane keeps its columns inside the
//     head. The host (ops/spmm_blocked.py, k10_panels) picks V and the
//     panel. A head narrower than a piece leaves lanes idle, and each head
//     walks its items' slots once: narrow heads cost several times their
//     share;
//   - a warp loads 32 slots' column ids and weights at once and broadcasts
//     them by shuffle, and gathers the rows of 8 slots before it adds any,
//     so several KB are in flight a warp;
//   - each row is stored once, by one vector store a piece, so no output is
//     zeroed beforehand and a row's sum is the same from run to run. Only a
//     row split over several items meets the others by atomicAdd, into rows
//     the wrapper zeroed; the order of those atomics, and so the last bits
//     of such a row, varies from run to run.
//
// The stream is f32 (the JAX package streams bf16 only on the rowmask
// route); products and sums are f32, only the sums' order differs from the
// plain version's.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_sum_blocked-<hash>.so \
//        segment_sum_blocked.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kUnroll = 8;  // row gathers in flight a warp
constexpr unsigned kFull = 0xffffffffu;

template <int kV>
__device__ __forceinline__ void load_v(const float* p, float (&v)[kV]) {
  if constexpr (kV == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (kV == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int kV>
__device__ __forceinline__ void store_v(float* p, const float (&v)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (kV == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// kV columns a lane loads at once; kPieces pieces of 32 * kV columns make
// the panel a warp holds. blockIdx.y = head * per_head + panel of the head.
// kCross: F % kV != 0, so the head's panels start at its first column
// rounded down to kV, and a piece at either end of the head holds columns
// of the next or the last head, which the lane neither adds nor stores. It
// is a template parameter on purpose: with the masks worked out at run time
// for every F, nvcc 12.8 scheduled the gathers worse and 4 x 256 ran
// markedly slower on an H100.
template <int kV, int kPieces, bool kCross>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
segment_sum_blocked_kernel(const int32_t* __restrict__ item_row,
                           const int32_t* __restrict__ item_beg,
                           const int32_t* __restrict__ item_end,
                           int num_items, const int32_t* __restrict__ cols,
                           const float* __restrict__ w, int64_t cb,
                           const float* __restrict__ feats,
                           float* __restrict__ out, int hf, int f,
                           int per_head) {
  constexpr int kPiece = 32 * kV;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (item >= num_items) return;  // warp-uniform
  const int coded = item_row[item];
  const bool split = coded < 0;  // the row spans several items
  const int64_t row = split ? ~coded : coded;
  const int beg = item_beg[item];
  const int end = item_end[item];
  const int panel_head = blockIdx.y / per_head;
  const int c_beg = panel_head * f;
  const int c_end = c_beg + f;
  const int c0 = (kCross ? c_beg / kV * kV : c_beg) + (blockIdx.y % per_head) * kPieces * kPiece + lane * kV;

  // Per piece: whether it holds a column of the head, and (head * 16 +
  // mask) the mask of its columns inside the head. The head is packed in,
  // and the weights' address formed inside the slot loop, on purpose: with
  // the mask alone, or the head's weight pointer hoisted out of the loop,
  // nvcc 12.8 scheduled the gathers worse and 6 x 121 ran markedly slower
  // on an H100.
  bool live[kPieces];
  int hc[kPieces];
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int c = c0 + p * kPiece;
    live[p] = c < c_end && (!kCross || c + kV > c_beg);
    int x = (1 << kV) - 1;
    if (kCross) {
      x = 0;
#pragma unroll
      for (int k = 0; k < kV; ++k) x |= (c + k >= c_beg && c + k < c_end) << k;
    }
    hc[p] = panel_head * 16 + x;
  }

  float acc[kPieces][kV];
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
#pragma unroll
    for (int k = 0; k < kV; ++k) acc[p][k] = 0.f;
  }

  for (int base = beg; base < end; base += 32) {
    const int my_col = base + lane < end ? cols[base + lane] : 0;
    const float my_w = base + lane < end ? __ldg(w + panel_head * cb + base + lane) : 0.f;
    const int cnt = min(32, end - base);  // warp-uniform
    for (int j0 = 0; j0 < cnt; j0 += kUnroll) {
      float v[kUnroll][kPieces][kV];
      float wl[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool on = j0 + u < cnt;  // warp-uniform
        const int src = __shfl_sync(kFull, my_col, (j0 + u) & 31);
        wl[u] = __shfl_sync(kFull, my_w, (j0 + u) & 31);
        const float* x = feats + static_cast<int64_t>(src) * hf + c0;
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          if (on && live[p]) {
            load_v<kV>(x + p * kPiece, v[u][p]);
          } else {
#pragma unroll
            for (int k = 0; k < kV; ++k) v[u][p][k] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= cnt) break;  // warp-uniform
#pragma unroll
        for (int p = 0; p < kPieces; ++p) {
          const float lo = wl[u];
#pragma unroll
          for (int k = 0; k < kV; ++k) {
            acc[p][k] += __fmul_rn(v[u][p][k], lo);
          }
        }
      }
    }
  }

  float* o = out + row * hf + c0;
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    if (!live[p]) continue;
    const int mask = kCross ? hc[p] & 15 : (1 << kV) - 1;  // the columns this panel owns
    if (split) {
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        if ((mask >> k) & 1) atomicAdd(o + p * kPiece + k, acc[p][k]);
      }
    } else if (mask == (1 << kV) - 1) {
      store_v<kV>(o + p * kPiece, acc[p]);
    } else {  // a piece at a head boundary: its columns inside the head
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        if ((mask >> k) & 1) o[p * kPiece + k] = acc[p][k];
      }
    }
  }
}

template <int kV, int kPieces>
int launch(const int32_t* item_row, const int32_t* item_beg,
           const int32_t* item_end, int num_items, const int32_t* cols,
           const float* w, int64_t cb, const float* x, float* out, int hf,
           int f, int heads, int per_head, cudaStream_t stream) {
  // the head's panels must cover it from its first column rounded down
  const int span = f % kV ? f + kV - 1 : f;
  if (hf % kV || static_cast<int64_t>(per_head) * kPieces * 32 * kV < span ||
      static_cast<int64_t>(heads) * per_head > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (reinterpret_cast<uintptr_t>(x) % (4 * kV) || reinterpret_cast<uintptr_t>(out) % (4 * kV)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const dim3 grid((num_items + kWarpsPerBlock - 1) / kWarpsPerBlock, heads * per_head);
  if (kV > 1 && f % kV) {
    segment_sum_blocked_kernel<kV, kPieces, true><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        item_row, item_beg, item_end, num_items, cols, w, cb, x, out, hf, f, per_head);
  } else {
    segment_sum_blocked_kernel<kV, kPieces, false><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        item_row, item_beg, item_end, num_items, cols, w, cb, x, out, hf, f, per_head);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K10 on `stream` and returns a cudaError_t (0 on success; the
// launch's cudaGetLastError(), or cudaErrorInvalidValue /
// cudaErrorMisalignedAddress for a geometry it does not take). Item i
// covers slots [item_beg[i], item_end[i]) of one row: item_row[i] = d, or
// ~d where row d spans several items (those rows of `out` must be zeroed by
// the caller; every other row is written by its one item). `cols` is the
// layout's (cb,) int32, `w` (heads, cb) f32, `feats` (n, hf) f32 contiguous
// with hf = heads * f, `out` (n, hf) f32. A lane loads `v` columns at once
// (both tables aligned to 4 * v bytes), a warp holds `pieces` pieces of
// 32 * v columns of one head, and a head takes `per_head` panels (v and
// pieces: 4 and 1, 2 and 1 or 2, 1 and 1, 2 or 4).
extern "C" int stg_segment_sum_blocked(const void* item_row,
                                       const void* item_beg,
                                       const void* item_end, int num_items,
                                       const void* cols, const void* w,
                                       int64_t cb, const void* feats,
                                       void* out, int hf, int f, int heads,
                                       int v, int pieces, int per_head,
                                       void* stream) {
  const auto* ir = static_cast<const int32_t*>(item_row);
  const auto* ib = static_cast<const int32_t*>(item_beg);
  const auto* ie = static_cast<const int32_t*>(item_end);
  const auto* c = static_cast<const int32_t*>(cols);
  const auto* wt = static_cast<const float*>(w);
  const auto* x = static_cast<const float*>(feats);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (hf != heads * f || per_head < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (v * 8 + pieces) {
    case 4 * 8 + 1:
      return launch<4, 1>(ir, ib, ie, num_items, c, wt, cb, x, o, hf, f, heads, per_head, s);
    case 2 * 8 + 1:
      return launch<2, 1>(ir, ib, ie, num_items, c, wt, cb, x, o, hf, f, heads, per_head, s);
    case 2 * 8 + 2:
      return launch<2, 2>(ir, ib, ie, num_items, c, wt, cb, x, o, hf, f, heads, per_head, s);
    case 1 * 8 + 1:
      return launch<1, 1>(ir, ib, ie, num_items, c, wt, cb, x, o, hf, f, heads, per_head, s);
    case 1 * 8 + 2:
      return launch<1, 2>(ir, ib, ie, num_items, c, wt, cb, x, o, hf, f, heads, per_head, s);
    case 1 * 8 + 4:
      return launch<1, 4>(ir, ib, ie, num_items, c, wt, cb, x, o, hf, f, heads, per_head, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
