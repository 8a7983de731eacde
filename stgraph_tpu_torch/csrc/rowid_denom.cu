// K7 on Hopper: per-row live count or weight sum of a flat row-id edge store.
//
//   den[r] = sum_{slots e with rows[e] == r} v(e)
//
// with v(e) = 1 (count mode: every slot whose row id is below n), w[e]
// (weighted mode) or [w[e] > 0] (indicator mode: lazy_norm's live edges).
//
// Replaces the TPU kernel dyn_spmm._rowid_denom_kernel
// (stgraph_tpu/ops/dyn_spmm.py:382, reached from dyn_degree at pallas_call
// :483), which feeds the per-timestep GCN norms of the lazy dynamic store
// (lazy_norm, once in every GCNConv on a store pair).
//
// The store is "live-sorted": slots whose row id is in [0, n) are in
// nondecreasing row order; sentinel slots (row id n) may sit anywhere;
// tombstones keep their row id and carry w = 0. The store changes every
// timestep on the device, so the kernel finds its work from the device
// arrays alone.
//
// What bounds it on an H100: memory, and at the shapes it runs at, launch
// latency. It reads rows and w once and writes den once: 22 MB, about 7 us,
// at 2.2M slots and 1.1M rows; at the DTDG epochs' shapes (129 and 20,000
// rows) the bound is far below a launch.
//
// The first design (a thread a run of 16 slots, so a warp's loads 64 B
// apart; each run of a row flushed by atomicAdd into den, which the
// wrapper zeroed in a launch of its own, after lazy_norm's torch.where)
// made lazy_norm's call three launches; at the DTDG shapes their issue, not
// the bytes, was the time (PERF.md §6). This design is one launch:
//   - a warp takes a span of kP passes of 128 slots; in a pass lane i reads
//     slots 4i..4i+3 as one 16 B load of rows and one of w, so each load of
//     the warp is 512 contiguous bytes, and all passes' loads are issued
//     before any sum;
//   - a lane reduces its 4 slots to (first live row, last live row, sum of
//     the last row's slots), and the warp scans these by shuffles (a
//     segmented scan: a later segment restarts the sum unless its rows are
//     all the earlier one's last row), which gives each lane the row and
//     partial sum it continues;
//   - spans take their ids from an atomic ticket, never from blockIdx, so a
//     span's predecessors are resident. A span publishes its aggregate at
//     once, then looks back over its predecessors 32 at a time for the row
//     it continues and that row's sum so far (stopping at the first that
//     published its inclusive value, or where the row begins), and
//     publishes its own inclusive value; a row's sum is a left fold of its
//     spans' partial sums, in span order, whatever the timing. A status
//     word carries the launch's epoch, so it needs no zeroing between
//     launches; the last span resets the ticket;
//   - a row's sum is stored once, as a plain store, by the lane that holds
//     the first live slot after the row's last slot (the last live row by
//     the last span). Rows with no slot are zeroed in the same launch: the
//     warp first zeroes every row strictly between its span's first and
//     last live row (coalesced; the lanes' sums then overwrite the rows
//     that have slots), and the gap before a span's first live row, the
//     rows before the store's first live row and after its last are zeroed
//     by all 32 lanes striding over them. Zeroing each gap where a lane met
//     it took 6-20 us of the 23-39 us at the dyn-step store, where one row
//     in seven has no slot (PERF.md §6). No zero fill: den comes from
//     torch.empty.
//
// Counts and indicator sums (integers below 2^24) are exact in any order;
// weighted sums are f32, in a fixed order.
//
// Build (done by stgraph_tpu_torch/ops/kernel_lib.py at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/kernels/librowid_denom-<hash>.so rowid_denom.cu

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kV = 4;              // slots a lane takes in a pass
constexpr int kPass = 32 * kV;     // slots a pass
constexpr int kP = 2;              // passes a span (1 and 4 measured slower, PERF.md §6)
constexpr unsigned kFull = 0xffffffffu;

// A run of slots reduced: its first and last live row (-1, -1 when it has
// none) and the sum of the last row's values in it.
struct Seg {
  int f, l;
  float s;
};

__device__ __forceinline__ Seg none() { return Seg{-1, -1, 0.f}; }

// a followed by b
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  if (b.l < 0) return a;
  if (a.l < 0) return b;
  return Seg{a.f, b.l, b.l == a.l ? a.s + b.s : b.s};
}

__device__ __forceinline__ Seg shfl_seg(const Seg& x, int src) {
  return Seg{__shfl_sync(kFull, x.f, src), __shfl_sync(kFull, x.l, src), __shfl_sync(kFull, x.s, src)};
}

// A status word is read and written whole, as one 16 B access, so a reader
// never sees one launch's flag beside another's fields.
__device__ __forceinline__ int4 load_status(const int4* p) {
  int4 v;
  asm volatile("ld.volatile.global.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void store_status(int4* p, int4 v) {
  asm volatile("st.volatile.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// kMode 0: count, 1: weighted, 2: indicator.
template <int kMode>
__device__ __forceinline__ float value(float w) {
  return kMode == 0 ? 1.f : (kMode == 1 ? w : (w > 0.f ? 1.f : 0.f));
}

// Zeroes den[lo, lo + len) of every lane with len > 0, all 32 lanes
// striding over each.
__device__ __forceinline__ void zero_gaps(float* den, int lo, int len, int lane) {
  unsigned mask = __ballot_sync(kFull, len > 0);
  while (mask) {
    const int src = __ffs(mask) - 1;
    const int a = __shfl_sync(kFull, lo, src);
    const int m = __shfl_sync(kFull, len, src);
    for (int i = lane; i < m; i += 32) den[a + i] = 0.f;
    mask &= mask - 1;
  }
}

// A warp a span of kP passes. `status` holds one int4 a span: its aggregate
// (first row, last row, sum bits, 2 epoch) or its inclusive value
// (-, row, sum bits, 2 epoch + 1).
template <int kMode>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rowid_denom_kernel(const int32_t* __restrict__ rows, const float* __restrict__ w,
                   float* __restrict__ den, int4* __restrict__ status,
                   unsigned int* __restrict__ ticket, int64_t cap, int n, int spans, int epoch) {
  const int lane = threadIdx.x & 31;
  if (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5) >= spans) return;  // warp-uniform
  int s = 0;
  if (lane == 0) {
    s = static_cast<int>(atomicAdd(ticket, 1u));
    if (s == spans - 1) *ticket = 0u;  // every span has its ticket: ready for the next launch
  }
  s = __shfl_sync(kFull, s, 0);

  // every pass's slots, loaded before any sum
  int r[kP][kV];
  float v[kP][kV];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int64_t e = static_cast<int64_t>(s) * (kP * kPass) + p * kPass + kV * lane;
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
      v[p][j] = value<kMode>(kMode != 0 ? v[p][j] : 0.f);
      if (r[p][j] < 0 || r[p][j] >= n) r[p][j] = -1;  // a sentinel
    }
  }

  // each lane's runs, scanned over the warp pass by pass
  Seg ex[kP];   // what precedes the lane inside its pass
  Seg tot[kP];  // the pass
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

  // the rows strictly between the span's first and last live row have all
  // their slots here, so only this warp writes them: zeros first, each
  // lane's sums over them after
  for (int i = agg.f + 1 + lane; i < agg.l; i += 32) den[i] = 0.f;
  __syncwarp();

  // publish the aggregate, find the carry (the row this span continues and
  // its sum so far), publish the inclusive value
  Seg carry = none();
  if (s > 0) {
    if (lane == 0) store_status(status + s, make_int4(agg.f, agg.l, __float_as_int(agg.s), 2 * epoch));
    bool done = false;
    for (int q0 = s - 1; !done; q0 -= 32) {
      const int q = q0 - lane;
      int4 d = make_int4(-1, -1, 0, 2 * epoch + 1);  // before span 0: an inclusive value of nothing
      if (q >= 0) {
        do {
          d = load_status(status + q);
        } while ((d.w >> 1) != epoch);
      }
      const bool inc = d.w & 1;
      const unsigned informative = __ballot_sync(kFull, inc || d.y >= 0);
      if (informative == 0) continue;  // 32 spans without a live slot
      const int i0 = __ffs(informative) - 1;
      const int row = __shfl_sync(kFull, d.y, i0);  // the nearest live row
      if (row < 0) break;                          // none before this span: carry stays none
      // where the chain of spans holding `row` ends: an inclusive value, a
      // span where the row begins, or one whose last row is another
      const bool ends = lane >= i0 && (inc || (d.y >= 0 && (d.y != row || d.x != d.y)));
      const unsigned enders = __ballot_sync(kFull, ends);
      if (enders == 0) {
        // longer than the window: the nearest span's inclusive value
        if (lane == 0) {
          do {
            d = load_status(status + s - 1);
          } while (d.w != 2 * epoch + 1);
        }
        carry = Seg{__shfl_sync(kFull, d.y, 0), __shfl_sync(kFull, d.y, 0),
                    __int_as_float(__shfl_sync(kFull, d.z, 0))};
        break;
      }
      const int j = __ffs(enders) - 1;
      const bool adds = lane >= i0 && lane <= j && d.y == row;
      float sum = 0.f;
      bool any = false;
      for (int i = j; i >= i0; --i) {  // oldest first: a left fold in span order
        const float z = __int_as_float(__shfl_sync(kFull, d.z, i));
        if (__shfl_sync(kFull, adds, i)) {
          sum = any ? sum + z : z;
          any = true;
        }
      }
      carry = Seg{row, row, sum};
      done = true;
    }
  }
  const Seg inclusive = combine(carry, agg);
  if (lane == 0) {
    store_status(status + s, make_int4(inclusive.f, inclusive.l, __float_as_int(inclusive.s), 2 * epoch + 1));
  }

  // each pass: every row whose next live slot is this lane's stored over
  // the zeros, and the gap before the span's first live row zeroed
  Seg c = carry;
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const Seg in = combine(c, ex[p]);
    int prev = in.l;
    float acc = in.s;
    int lo = 0, len = 0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      const int rj = r[p][j];
      if (rj < 0) continue;
      if (rj != prev) {
        if (prev >= 0) den[prev] = acc;
        if (prev < agg.f) {  // the span's first live slot, after rows of no slot
          lo = prev + 1;
          len = rj - prev - 1;
        }
        prev = rj;
        acc = 0.f;
      }
      acc += v[p][j];
    }
    zero_gaps(den, lo, len, lane);
    c = combine(c, tot[p]);
  }

  // the last span: the last live row, and the rows after it
  if (s == spans - 1) {
    if (lane == 0 && inclusive.l >= 0) den[inclusive.l] = inclusive.s;
    for (int i = inclusive.l + 1 + lane; i < n; i += 32) den[i] = 0.f;
  }
}

template <int kMode>
void launch(const int32_t* rows, const float* w, float* den, int4* status, unsigned* ticket, int64_t cap,
            int n, int spans, int epoch, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>((spans + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  rowid_denom_kernel<kMode><<<grid, block, 0, st>>>(rows, w, den, status, ticket, cap, n, spans, epoch);
}

}  // namespace

// Launches K7 on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for arguments it does not take.
// `rows` (cap,) int32 and `w` (cap,) f32, both 16 B aligned; `w` is null in
// mode 0 (count the slots whose row id is in [0, n)), else mode 1 sums w
// and mode 2 counts w > 0. `den` (n,) f32 needs no zeroing: every row is
// written. A warp takes a span of kP x 128 = 256 slots;
// `status` holds at least ceil(cap / 256) int4 whose epoch fields
// are below `epoch` (zeros, then the earlier launches'); `ticket` is 0 and
// is left 0. `epoch` is in [1, 2^30) and grows from launch to launch on the
// same status words, whose launches stay ordered on one stream.
extern "C" int stg_rowid_denom(const void* rows, const void* w, void* den, void* status, void* ticket,
                               int64_t cap, int n, int mode, int epoch, void* stream) {
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* wt = static_cast<const float*>(w);
  auto* d = static_cast<float*>(den);
  auto* stt = static_cast<int4*>(status);
  auto* tk = static_cast<unsigned*>(ticket);
  auto st = static_cast<cudaStream_t>(stream);
  if (cap < 1 || n < 1 || (mode != 0) != (wt != nullptr) || mode < 0 || mode > 2 ||
      epoch < 1 || epoch >= (1 << 30) ||
      reinterpret_cast<uintptr_t>(r) % 16 != 0 || reinterpret_cast<uintptr_t>(wt) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t spans = (cap + kPass * kP - 1) / (kPass * kP);
  if (spans >= (int64_t{1} << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    launch<0>(r, wt, d, stt, tk, cap, n, static_cast<int>(spans), epoch, st);
  } else if (mode == 1) {
    launch<1>(r, wt, d, stt, tk, cap, n, static_cast<int>(spans), epoch, st);
  } else {
    launch<2>(r, wt, d, stt, tk, cap, n, static_cast<int>(spans), epoch, st);
  }
  return static_cast<int>(cudaGetLastError());
}
