// K4 on Hopper: the narrow segment max over a CSR.
//
//   out[d, k] = max_{e in [indptr[d], indptr[d+1])} vals[index[e], k]
//
// for k < K, K <= 16 (MAX_NARROW_K), f32. Without `index` the values are read
// per edge, vals[e, k] (an (E, K) plane in CSR order). Empty rows give 0, as
// do rows whose maximum is -inf. Padding slots (positions at or past
// indptr[n]) belong to no row and are never read.
//
// Replaces the TPU kernel segment_pallas._narrow_max_kernel
// (stgraph_tpu/ops/segment_pallas.py:235, reached from segment_max_narrow at
// pallas_call :427). flash-GAT's forward uses it for the stability max of
// its softmax, max_e el[src_e, h], with vals = el (N, H) and index = cols,
// so no (E, H) plane is built (3.96 GB at ogbn-products size, H = 8).
//
// What bounds it on an H100: memory. It does one compare per edge and
// column, while the gather of el[cols[e]] reads a 32 B sector per edge
// (H = 8) spread over the whole table. The compulsory bytes (indptr, cols,
// the table once, the output once) give a bound of about 0.2 ms at
// ogbn-products size; the gathered sectors are about 4 GB. At H = 1 the
// table (9.8 MB) sits in L2 and the stream of `cols` is what must move.
//
// The first design (a warp a row, one edge a lane an iteration, K dependent
// scalar loads behind each index load, 5 shuffles a column and a second
// launch for split rows) ran 5.7x its bound at H = 1 and 11x at H = 8
// (PERF.md §6): each lane waited out a memory latency per edge, and a row's
// chain of dependent loads (item, row bounds, indices, values) was the
// only work of its warp. This design:
//   - gives each work item kL = 16 lanes, so a warp walks two items at once
//     (8 and 32 lanes measured slower at K = 8 and no faster at K = 1:
//     PERF.md §6);
//   - keeps kU edges a lane in flight: a batch's kU indices are loaded
//     together (coalesced across the item's lanes), then all their rows,
//     and the next batch's indices are loaded before this batch's rows are
//     compared;
//   - reads a row with vector loads of W values (16 B at K = 4, 8, 12, 16;
//     8 B at other even K) where the table is aligned for them, scalar
//     loads otherwise;
//   - meets the item's maxima by a transpose reduction: at each shuffle
//     level a lane keeps half of its columns and hands the other half to
//     its partner, so log2(kL) + K - 1 shuffles (K a power of two) serve
//     all K columns instead of 5 a column; the lanes then hold the row's
//     columns in order and store them side by side;
//   - splits a row of more than `chunk` edges into several items whose
//     maxima meet by an atomic float max (an int max for non-negative
//     values, an unsigned min for negative ones) in rows the wrapper filled
//     with -inf. The last item of a split row to finish (a ticket counter a
//     split row, reset by that item for the next launch) maps -inf to 0 in
//     it, so no second launch finishes the split rows.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_max_narrow-<hash>.so \
//        segment_max_narrow.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kL = 16;  // lanes a work item
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNegInfBits = 0xff800000u;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(kNegInfBits); }

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x >> 1); }
__host__ __device__ constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }

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

// Row r's K values, W at a time (W divides K; the row is 4 W-byte aligned).
template <int K, int W>
__device__ __forceinline__ void load_row(const float* vals, int64_t r, float (&v)[K]) {
  const float* p = vals + r * K;
#pragma unroll
  for (int i = 0; i < K; i += W) {
    if constexpr (W == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    } else if constexpr (W == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p + i));
      v[i] = q.x;
      v[i + 1] = q.y;
    } else {
      v[i] = __ldg(p + i);
    }
  }
}

// The slot of `row` in the sorted `split_rows` (present by construction).
__device__ __forceinline__ int split_slot(const int64_t* split_rows, int num_split, int row) {
  int lo = 0, hi = num_split - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(split_rows + mid) < row) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// kL lanes a work item (32 / kL items a warp), K columns read W at a time.
template <int K, int W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_max_narrow_kernel(const int32_t* __restrict__ indptr,
                          const int32_t* __restrict__ index,
                          const float* __restrict__ vals,
                          const int32_t* __restrict__ item_row,
                          const int32_t* __restrict__ item_beg,
                          const int64_t* __restrict__ split_rows,
                          int num_split, int* __restrict__ tickets,
                          float* __restrict__ out, int num_items, int chunk) {
  constexpr int kP = pow2_at_least(K);              // columns, padded to a power of two
  constexpr int kU = K <= 2 ? 8 : (K <= 8 ? 4 : 2);  // edges a lane keeps in flight
  constexpr int kBatch = kL * kU;                     // edges an item takes at once
  constexpr int kR = kP > kL ? kP / kL : 1;           // columns a lane holds after the meeting

  const int lane = threadIdx.x & 31;
  const int sl = lane % kL;  // the lane's place in its item
  const int item = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / kL) + lane / kL;
  const bool valid = item < num_items;  // not warp-uniform: every lane meets the shuffles
  int row = 0, row_beg = 0, row_end = 0, beg = 0, end = 0;
  if (valid) {
    row = item_row[item];
    beg = item_beg[item];
    row_beg = indptr[row];
    row_end = indptr[row + 1];
    end = min(beg + chunk, row_end);
  }
  const bool split = row_end - row_beg > chunk;

  float acc[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) acc[k] = neg_inf();
  int idx[kU];  // the rows of the batch's edges (-1: no edge)
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = beg + u * kL + sl;
    idx[u] = e < end ? (index != nullptr ? __ldg(index + e) : e) : -1;
  }
  for (int b0 = beg; b0 < end; b0 += kBatch) {
    float v[kU][K];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (idx[u] >= 0) {
        load_row<K, W>(vals, idx[u], v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) v[u][k] = neg_inf();
      }
    }
    // the next batch's indices, while this batch's rows are in flight
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = b0 + kBatch + u * kL + sl;
      idx[u] = e < end ? (index != nullptr ? __ldg(index + e) : e) : -1;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] = fmaxf(acc[k], v[u][k]);
    }
  }

  // The item's lanes meet by a transpose reduction: at each level a lane
  // keeps one half of its columns, hands the other to its partner (lane ^ s)
  // and takes the partner's half of the same columns; once one column is
  // left the remaining levels take it alone. The lane ends holding columns
  // [c0, c0 + kR): c0 = sl >> (log2 kL - log2 kP) when kP <= kL, else sl kR.
#pragma unroll
  for (int lvl = 0, s = kL >> 1; s > 0; ++lvl, s >>= 1) {
    const int half = (kP >> lvl) >> 1;
    if (half > 0) {
      const bool upper = (lane & s) != 0;
#pragma unroll
      for (int i = 0; i < kP / 2; ++i) {
        if (i < half) {
          const float send = upper ? acc[i] : acc[half + i];
          const float keep = upper ? acc[half + i] : acc[i];
          acc[i] = fmaxf(keep, __shfl_xor_sync(kFull, send, s));
        }
      }
    } else {
      acc[0] = fmaxf(acc[0], __shfl_xor_sync(kFull, acc[0], s));
    }
  }
  const int c0 = kP <= kL ? sl >> (log2i(kL) - log2i(kP)) : sl * kR;
  const bool stores = valid && (kP <= kL ? (sl & (kL / kP - 1)) == 0 : true);
  float* o = out + static_cast<int64_t>(row) * K;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = c0 + i;
    if (stores && c < K) {
      if (split) {
        atomic_max_float(o + c, acc[i]);
      } else {
        o[c] = acc[i] == neg_inf() ? 0.f : acc[i];
      }
    }
  }

  // A split row's last item to finish maps -inf (no value above it) to 0.
  if (split) __threadfence();  // this lane's atomics before the item's ticket
  __syncwarp();
  int last = 0;
  if (split && sl == 0) {
    const int slot = split_slot(split_rows, num_split, row);
    const int items = (row_end - row_beg + chunk - 1) / chunk;
    last = atomicAdd(tickets + slot, 1) == items - 1;
    if (last) tickets[slot] = 0;  // ready for the next launch
  }
  last = __shfl_sync(kFull, last, lane & ~(kL - 1));
  if (last) {
    __threadfence();
    for (int c = sl; c < K; c += kL) {
      atomicCAS(reinterpret_cast<unsigned int*>(o + c), kNegInfBits, 0u);
    }
  }
}

struct Args {
  const int32_t* indptr;
  const int32_t* index;
  const float* vals;
  const int32_t* item_row;
  const int32_t* item_beg;
  const int64_t* split_rows;
  int num_split;
  int* tickets;
  float* out;
  int num_items, chunk;
  cudaStream_t stream;
};

template <int K, int W>
void launch(const Args& a) {
  constexpr int kItemsPerBlock = kWarpsPerBlock * (32 / kL);
  const dim3 grid((a.num_items + kItemsPerBlock - 1) / kItemsPerBlock);
  segment_max_narrow_kernel<K, W><<<grid, kWarpsPerBlock * 32, 0, a.stream>>>(
      a.indptr, a.index, a.vals, a.item_row, a.item_beg, a.split_rows, a.num_split, a.tickets, a.out,
      a.num_items, a.chunk);
}

// The widest loads the table takes: 16 B where K % 4 == 0, 8 B where K is
// even, with the table aligned for them; scalar loads otherwise.
template <int K>
void launch_k(const Args& a) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.vals);
  if constexpr (K % 4 == 0) {
    if (base % 16 == 0) return launch<K, 4>(a);
  }
  if constexpr (K % 2 == 0) {
    if (base % 8 == 0) return launch<K, 2>(a);
  }
  launch<K, 1>(a);
}

}  // namespace

// Launches K4 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a width it was not built for.
// `vals` is (rows, k) f32 with k <= 16: per edge in CSR order when `index`
// is null, else a node table read at index[e]. `out` is (n, k) f32, with the
// `num_split` rows listed in `split_rows` (int64, ascending) filled with -inf
// by the caller; `tickets` holds num_split int32 zeros, and the kernel
// leaves them zero. The kernel writes every element of every row; a work
// item holds at most `chunk` edges (ops/segment_kernels.K4_CHUNK).
extern "C" int stg_segment_max_narrow(const void* indptr, const void* index,
                                      const void* vals, const void* item_row,
                                      const void* item_beg, int num_items,
                                      const void* split_rows, int num_split,
                                      void* tickets, void* out, int k,
                                      int chunk, void* stream) {
  Args a;
  a.indptr = static_cast<const int32_t*>(indptr);
  a.index = static_cast<const int32_t*>(index);
  a.vals = static_cast<const float*>(vals);
  a.item_row = static_cast<const int32_t*>(item_row);
  a.item_beg = static_cast<const int32_t*>(item_beg);
  a.split_rows = static_cast<const int64_t*>(split_rows);
  a.num_split = num_split;
  a.tickets = static_cast<int*>(tickets);
  a.out = static_cast<float*>(out);
  a.num_items = num_items;
  a.chunk = chunk;
  a.stream = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || (num_split > 0 && (split_rows == nullptr || tickets == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (k) {
    case 1: launch_k<1>(a); break;
    case 2: launch_k<2>(a); break;
    case 3: launch_k<3>(a); break;
    case 4: launch_k<4>(a); break;
    case 5: launch_k<5>(a); break;
    case 6: launch_k<6>(a); break;
    case 7: launch_k<7>(a); break;
    case 8: launch_k<8>(a); break;
    case 9: launch_k<9>(a); break;
    case 10: launch_k<10>(a); break;
    case 11: launch_k<11>(a); break;
    case 12: launch_k<12>(a); break;
    case 13: launch_k<13>(a); break;
    case 14: launch_k<14>(a); break;
    case 15: launch_k<15>(a); break;
    case 16: launch_k<16>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
