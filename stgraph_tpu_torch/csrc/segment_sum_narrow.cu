// K3 on Hopper: the narrow segment sum over a CSR.
//
//   out[d, k] = sum_{e in [indptr[d], indptr[d+1])} vals[e, k]
//
// for k < K, K <= 16 (MAX_NARROW_K), f32, with vals an (E, K) plane in CSR
// order. Empty rows give 0. Padding slots (positions at or past indptr[n])
// belong to no row and are never read.
//
// Replaces the TPU kernel segment_pallas._narrow_sum_kernel
// (stgraph_tpu/ops/segment_pallas.py:155, reached from segment_sum_narrow at
// pallas_call :351). The composed GAT route uses it for the softmax
// denominator (per destination, on the forward CSR) and, in backward, for
// d er (forward CSR) and d el (transpose CSR).
//
// What bounds it on an H100: memory. One add per edge and column; the
// compulsory bytes (indptr, the (E, K) plane once, the output once) give
// about 0.6 ms at ogbn-products size with K = 4, and the plane is read in
// CSR order, so every byte read is a compulsory one. At the GAT paper's PPI
// size (818,716 edges) the bound is 4-6 us, so a call's fixed costs (its
// launch, the chain of loads before the first value) are most of it.
//
// The first design (a warp a 1024-edge work item, the item's row, first
// edge and row bounds loaded one after the other before any value, one edge
// a lane an iteration with K scalar loads, 5 shuffles a column, split rows
// met by atomicAdd in rows a second launch had zeroed) ran at about 10 % of
// its bound at PPI size, and its hub rows' sums changed in their last bits
// from run to run (PERF.md §6). This design is K4's (segment_max_narrow.cu)
// with a sum:
//   - it walks host-built work items of at most `chunk` edges
//     (ops/segment_kernels.K3_CHUNK, k5_work_items), each one int4 (row, or
//     ~row when split; first edge; end; the split row's slot): one load
//     before the values; the split rows' items come first, so their rows'
//     last sums are done early and do not trail the launch;
//   - an item has kL = 8 lanes, so a warp walks four items at once (16 and
//     32 lanes measured slower at every main shape, PERF.md §6);
//   - a lane keeps kU edges in flight and issues the next batch's loads
//     before it adds this batch's values;
//   - it reads a row with vector loads of W values (16 B at K = 4, 8, 12,
//     16; 8 B at other even K) where the plane is aligned for them, scalar
//     loads otherwise;
//   - the item's lanes meet by a transpose reduction: log2(kL) + K - 1
//     shuffles (K a power of two) for all K columns, and the lanes that
//     hold the row's columns store them side by side;
//   - a split row (more than `chunk` edges) is finished in the same launch
//     and in a fixed order: each of its items stores its K sums in a
//     scratch slot of its own, and the item that takes the row's last
//     ticket sums the row's slots (lane l the slots l, l + kL, ..., each in
//     item order, then the same transpose meeting), stores the row and
//     resets the ticket for the next launch. No fill, no atomicAdd on the
//     output, one launch a call, and every sum (hub rows too) is the same
//     from run to run.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/libsegment_sum_narrow-<hash>.so \
//        segment_sum_narrow.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kL = 8;  // lanes a work item
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int log2i(int x) { return x <= 1 ? 0 : 1 + log2i(x >> 1); }
__host__ __device__ constexpr int pow2_at_least(int x) { return x <= 1 ? 1 : 2 * pow2_at_least((x + 1) / 2); }
// edges a lane keeps in flight at width K (at K = 4, 8 against 4: 3.5 %
// faster at ogbn-products size, 2 % slower at PPI's; twice these lost at
// every main shape, PERF.md §6)
__host__ __device__ constexpr int edges_in_flight(int k) { return k <= 4 ? 8 : (k <= 8 ? 4 : 2); }

// Row e's K values, W at a time (W divides K; the row is 4 W-byte aligned).
template <int K, int W>
__device__ __forceinline__ void load_row(const float* vals, int64_t e, float (&v)[K]) {
  const float* p = vals + e * K;
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

// One batch of a lane: the rows of edges e0, e0 + kL, ... (kU of them), 0
// at and past `end`.
template <int K, int W, int kU>
__device__ __forceinline__ void load_batch(const float* vals, int e0, int end, float (&v)[kU][K]) {
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int e = e0 + u * kL;
    if (e < end) {
      load_row<K, W>(vals, e, v[u]);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) v[u][k] = 0.f;
    }
  }
}

// The item's lanes meet by a transpose reduction: at each level a lane keeps
// one half of its columns, hands the other to its partner (lane ^ s) and
// takes the partner's half of the same columns; once one column is left the
// remaining levels take it alone. The lane ends holding the sums of columns
// [c0, c0 + kR) in acc[0, kR): c0 = sl >> (log2 kL - log2 kP) when
// kP <= kL, else sl kR. Every lane of the warp must take part.
template <int kP>
__device__ __forceinline__ void meet(float (&acc)[kP], int lane) {
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
          acc[i] = keep + __shfl_xor_sync(kFull, send, s);
        }
      }
    } else {
      acc[0] += __shfl_xor_sync(kFull, acc[0], s);
    }
  }
}

// kL lanes a work item (32 / kL items a warp), K columns read W at a time.
template <int K, int W>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_sum_narrow_kernel(const float* __restrict__ vals, const int4* __restrict__ items,
                          const int4* __restrict__ split, int* __restrict__ tickets,
                          float* __restrict__ scratch, float* __restrict__ out, int num_items, int chunk) {
  constexpr int kP = pow2_at_least(K);   // columns, padded to a power of two
  constexpr int kU = edges_in_flight(K);
  constexpr int kBatch = kL * kU;        // edges an item takes at once
  constexpr int kR = kP > kL ? kP / kL : 1;  // columns a lane holds after the meeting

  const int lane = threadIdx.x & 31;
  const int sl = lane % kL;  // the lane's place in its item
  const int item = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * (32 / kL) + lane / kL;
  const bool valid = item < num_items;  // not warp-uniform: every lane meets the shuffles
  int4 it = make_int4(0, 0, 0, -1);     // (row or ~row when split, first edge, end, split slot)
  if (valid) it = __ldg(items + item);
  const bool split_row = it.x < 0;
  const int row = split_row ? ~it.x : it.x;

  float acc[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) acc[k] = 0.f;
  {
    float cur[kU][K];
    load_batch<K, W, kU>(vals, it.y + sl, it.z, cur);
    for (int b0 = it.y; b0 < it.z; b0 += kBatch) {
      float nxt[kU][K];
      load_batch<K, W, kU>(vals, b0 + kBatch + sl, it.z, nxt);  // ahead of this batch's adds
#pragma unroll
      for (int u = 0; u < kU; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[k] += cur[u][k];
          cur[u][k] = nxt[u][k];
        }
      }
    }
  }
  meet<kP>(acc, lane);
  const int c0 = kP <= kL ? sl >> (log2i(kL) - log2i(kP)) : sl * kR;
  const bool holds = kP <= kL ? (sl & (kL / kP - 1)) == 0 : true;  // a lane with columns to store

  int4 sp = make_int4(0, 0, 0, 0);  // a split row's (first scratch slot, items, first edge, 0)
  if (valid && split_row) sp = __ldg(split + it.w);
  float* o = split_row ? scratch + static_cast<int64_t>(sp.x + (it.y - sp.z) / chunk) * K
                       : out + static_cast<int64_t>(row) * K;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int c = c0 + i;
    if (valid && holds && c < K) o[c] = acc[i];
  }

  // A split row's last item to take its ticket sums the row's scratch slots.
  if (split_row) __threadfence();  // this lane's partial sums before the item's ticket
  __syncwarp();
  int last = 0;
  if (valid && split_row && sl == 0) {
    last = atomicAdd(tickets + it.w, 1) == sp.y - 1;
    if (last) tickets[it.w] = 0;  // ready for the next launch
  }
  last = __shfl_sync(kFull, last, lane & ~(kL - 1));
  if (__any_sync(kFull, last)) {  // warp-uniform: every lane meets the shuffles
    if (last) __threadfence();     // the other items' partial sums after the ticket
#pragma unroll
    for (int k = 0; k < kP; ++k) acc[k] = 0.f;
    const int parts = last ? sp.y : 0;
    const float* p = scratch + static_cast<int64_t>(sp.x) * K;
#pragma unroll 4
    for (int j = sl; j < parts; j += kL) {  // in item order: lane sl the slots sl, sl + kL, ...
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k] += __ldcg(p + static_cast<int64_t>(j) * K + k);
    }
    meet<kP>(acc, lane);
    float* r = out + static_cast<int64_t>(row) * K;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int c = c0 + i;
      if (last && holds && c < K) r[c] = acc[i];
    }
  }
}

struct Args {
  const float* vals;
  const int4* items;
  const int4* split;
  int* tickets;
  float* scratch;
  float* out;
  int num_items, chunk;
  cudaStream_t stream;
};

template <int K, int W>
void launch(const Args& a) {
  constexpr int kItemsPerBlock = kWarpsPerBlock * (32 / kL);
  const dim3 grid((a.num_items + kItemsPerBlock - 1) / kItemsPerBlock);
  segment_sum_narrow_kernel<K, W><<<grid, kWarpsPerBlock * 32, 0, a.stream>>>(
      a.vals, a.items, a.split, a.tickets, a.scratch, a.out, a.num_items, a.chunk);
}

// The widest loads the plane takes: 16 B where K % 4 == 0, 8 B where K is
// even, with the plane aligned for them; scalar loads otherwise.
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

// Launches K3 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
// `vals` is the (capacity, k) f32 plane in CSR order, k <= 16. `items` holds
// `num_items` int4 work items (row, or ~row for a row split over several
// items; first edge; end; the split row's slot, or -1), every row of the
// CSR in at least one, each of at most `chunk` edges, a split row's items
// consecutive from its first edge (ops/segment_kernels.k5_work_items). A
// split row's slot indexes `split` (`num_split` int4: its first scratch
// slot, its item count, its first edge, 0) and `tickets` (int32 zeros, left
// zero by the kernel); `scratch` holds k f32 a scratch slot, one slot an
// item of a split row. `out` is (n, k) f32; the kernel writes every element
// of every row that has an item.
extern "C" int stg_segment_sum_narrow(const void* vals, const void* items, int num_items, const void* split,
                                      int num_split, void* tickets, void* scratch, void* out, int k, int chunk,
                                      void* stream) {
  if (chunk < 1 || num_items < 0 ||
      (num_split > 0 && (split == nullptr || tickets == nullptr || scratch == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.vals = static_cast<const float*>(vals);
  a.items = static_cast<const int4*>(items);
  a.split = static_cast<const int4*>(split);
  a.tickets = static_cast<int*>(tickets);
  a.scratch = static_cast<float*>(scratch);
  a.out = static_cast<float*>(out);
  a.num_items = num_items;
  a.chunk = chunk;
  a.stream = static_cast<cudaStream_t>(stream);
  if (num_items == 0) return static_cast<int>(cudaGetLastError());
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
