// The walk K8 (flash_gat_fwd.cu) and K9 (flash_gat_bwd.cu) share. A warp
// takes one work item (a row, or at most `chunk` edges of one) in rounds
// of kRound edges; a group of kG lanes takes one edge of a step, each lane
// kL 16 B pieces of the gathered row (kC columns). Each warp keeps a small
// ring of kStages rounds in shared memory, filled by cp.async kStages - 1
// rounds ahead of the round it works on, with what the round's weights
// need: the node fields of each (edge, head) pair (one pair a lane: el
// for K8, [er, m, c] for K9) and the edges' node ids. A round gathers its
// rows into registers first, forms its weights from fields that have
// landed while the rows are in flight, then multiplies. The kernels' notes
// say why; ops/flash_gat.flash_lanes picks kG and kL.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace stg {
namespace flash {

constexpr int kMaxWarpsPerBlock = 8;
// The kernels' launch bound asks for two blocks an SM: with none, ptxas held
// some main-path instances to 64 registers and spilled (the variants
// "bounds_1" and "source" of benchmarking/micro/k8_k9_bench.py).
constexpr int kMinBlocks = 2;
constexpr int kStages = 3;
constexpr int kSmemPerSm = 228 * 1024;    // an H100 SM's shared memory
constexpr int kSmemPerBlockMax = 227 * 1024;
constexpr int kSmemReserved = 1024;      // the system's share of each block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_lo(uint32_t pair) { return __uint_as_float(pair << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t pair) { return __uint_as_float(pair & 0xffff0000u); }

// The bf16 pair (lo, hi) of two f32 values that are bf16 already.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Both products of a pair, each the exact product rounded once to bf16.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// Asynchronous copies of node fields into shared memory (cp.async, 4 or
// 16 B), committed as one group a round.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_round() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Waits until at most kPending of this lane's committed rounds are in flight.
template <int kPending>
__device__ __forceinline__ void wait_rounds() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// T: the stream (float or __nv_bfloat16); kG lanes an edge (a power of two
// up to 32), kL 16 B pieces a lane (2 only for an f32 row past 128
// columns); kOneHead: all of a lane's kC columns lie in one head; kPair:
// the bytes of a pair's slot in the ring, 8 (K8: el, then w and w * lp)
// or 16 (K9: er, m, c, then w and w * lp).
template <typename T, int kG, int kL, bool kOneHead, int kPair>
struct Walk {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr int kV = 16 / static_cast<int>(sizeof(T));  // columns a 16 B piece
  static constexpr int kC = kV * kL;                            // columns a lane
  static constexpr int kEps = 32 / kG;                          // edges a step
  static constexpr int kSteps = kEps * 4 <= 32 ? 4 : 32 / kEps;  // steps a round
  static constexpr int kRound = kSteps * kEps;                  // edges a round, divides 32
  static constexpr int kNH = kOneHead ? 1 : kC;                 // head slots a lane

  // the ring of one round: the pair slots, then the node ids
  static __host__ __device__ int stage_bytes(int log_kh) { return (kRound << log_kh) * kPair + kRound * 4; }

  // Warps a block: of blocks of at most 8 warps, the size that lets an SM's
  // shared memory hold the most warps (the larger block on a tie; 8 but at
  // the widest rings).
  static int warps_per_block(int log_kh) {
    const int per_warp = kStages * stage_bytes(log_kh);
    int best = 1, most = 0;
    for (int w = 1; w <= kMaxWarpsPerBlock && w * per_warp <= kSmemPerBlockMax; ++w) {
      const int resident = kSmemPerSm / (w * per_warp + kSmemReserved) * w;
      if (resident >= most) {
        most = resident;
        best = w;
      }
    }
    return best;
  }
  static size_t smem_bytes(int log_kh) {
    return static_cast<size_t>(warps_per_block(log_kh)) * kStages * stage_bytes(log_kh);
  }

  int lane, h, hf, log_kh;
  int hs[kNH];  // the head of each of the lane's columns
  char* ring;   // the warp's ring

  __device__ __forceinline__ Walk(int lane_, int h_, int f, int hf_, int log_kh_, char* ring_)
      : lane(lane_), h(h_), hf(hf_), log_kh(log_kh_), ring(ring_) {
#pragma unroll
    for (int k = 0; k < kNH; ++k) hs[k] = min(col0() + k, hf - 1) / f;
  }

  // The lane's gathers: the edge of a step, its first column, whether it
  // holds columns of the row; and its weight pairs: head wh() of the
  // round's edges we(), we() + wstride(), ... (passes() of them). Derived
  // where used, so that they hold no registers across the walk.
  __device__ __forceinline__ int grp() const { return lane / kG; }
  __device__ __forceinline__ int col0() const { return (lane % kG) * kC; }
  __device__ __forceinline__ bool active() const { return col0() < hf; }
  __device__ __forceinline__ int wh() const { return lane & ((1 << log_kh) - 1); }
  __device__ __forceinline__ int we() const { return lane >> log_kh; }
  __device__ __forceinline__ int wstride() const { return 32 >> log_kh; }
  __device__ __forceinline__ int passes() const { return ((kRound << log_kh) + 31) >> 5; }
  __device__ __forceinline__ bool wh_ok() const { return wh() < h; }

  // An f32 value as the stream carries it.
  static __device__ __forceinline__ float stream(float x) { return kBf16 ? round_to_bf16(x) : x; }

  __device__ __forceinline__ char* stage(int r) const { return ring + (r % kStages) * stage_bytes(log_kh); }
  __device__ __forceinline__ char* slot(int r, int e, int head) const {
    return stage(r) + ((e << log_kh) + head) * kPair;
  }
  __device__ __forceinline__ int node(int r, int e) const {
    return reinterpret_cast<const int*>(stage(r) + (kRound << log_kh) * kPair)[e];
  }

  // Starts round r's copies: each pair's node fields (`fields` + node *
  // `node_stride` + head * `head_stride` floats, 4 B for K8, 16 B for K9)
  // and the nodes' ids. `my`: lane l holds the node of the round's edge l.
  __device__ __forceinline__ void issue(const float* __restrict__ fields, int node_stride, int head_stride, int my,
                                        int r, int cnt) const {
    char* st = stage(r);
#pragma unroll 1
    for (int t = 0; t < passes(); ++t) {
      const int e = we() + t * wstride();
      const int src = __shfl_sync(kFull, my, e & 31);
      if (wh_ok() && e < kRound && e < cnt) {
        const float* p = fields + static_cast<int64_t>(src) * node_stride + wh() * head_stride;
        if (kPair == 8) {
          copy_async4(slot(r, e, wh()), p);
        } else {
          copy_async16(slot(r, e, wh()), p);
        }
      }
    }
    if (lane < cnt && lane < kRound) {
      reinterpret_cast<int*>(st + (kRound << log_kh) * kPair)[lane] = my;
    }
  }

  // Issues the gathers of round r's rows from `table` (rows of `ld`
  // elements) into registers, the lane's pieces of each step (zero past the
  // round's `cnt` edges and past the row), not waiting on them.
  __device__ __forceinline__ void gather(const T* __restrict__ table, int ld, int r, int cnt,
                                         uint4 (&q)[kSteps][kL]) const {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int e = s * kEps + grp();
      const T* row = table + static_cast<int64_t>(e < cnt ? node(r, e) : 0) * ld + col0();
#pragma unroll
      for (int l = 0; l < kL; ++l) {
        q[s][l] = make_uint4(0u, 0u, 0u, 0u);
        if (e < cnt && col0() + l * kV < hf) q[s][l] = __ldg(reinterpret_cast<const uint4*>(row + l * kV));
      }
    }
  }

  // The formed weights (first, second) of edge e for the heads of the
  // lane's columns.
  __device__ __forceinline__ void weights(int r, int e, float2 (&v)[kNH]) const {
    const char* base = slot(r, e, 0);
#pragma unroll
    for (int k = 0; k < kNH; ++k) v[k] = *reinterpret_cast<const float2*>(base + hs[k] * kPair);
  }

  template <bool kSecond>
  static __device__ __forceinline__ float pick(const float2& x) { return kSecond ? x.y : x.x; }

  // acc[c] += round(x_c * w_c) over the lane's columns of one gathered row,
  // w_c the first (or, kSecond, the second) value of its head's slot,
  // which is a stream value.
  template <bool kSecond>
  __device__ __forceinline__ void madd(const uint4 (&q)[kL], const float2 (&v)[kNH], float (&acc)[kC]) const {
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const uint32_t raw[4] = {q[l].x, q[l].y, q[l].z, q[l].w};
      if constexpr (kBf16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = l * kV + 2 * i;
          const uint32_t w = bf16_pair(pick<kSecond>(v[kOneHead ? 0 : c]), pick<kSecond>(v[kOneHead ? 0 : c + 1]));
          const uint32_t pr = mul_bf16x2(raw[i], w);
          acc[c] += bf16_lo(pr);
          acc[c + 1] += bf16_hi(pr);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = l * kV + i;
          acc[c] += __fmul_rn(__uint_as_float(raw[i]), pick<kSecond>(v[kOneHead ? 0 : c]));
        }
      }
    }
  }

  // dla[c] = fma(a_c, round(x_c * g_c), dla[c]): x the lane's own columns
  // (xw: bf16 pairs, or f32 bits), g the gathered row, a_c the second value
  // of its head's slot (f32).
  __device__ __forceinline__ void madd_dot(const uint4 (&q)[kL], const uint32_t (&xw)[kC], const float2 (&v)[kNH],
                                           float (&dla)[kC]) const {
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const uint32_t raw[4] = {q[l].x, q[l].y, q[l].z, q[l].w};
      if constexpr (kBf16) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = l * kV + 2 * i;
          const uint32_t d = mul_bf16x2(xw[c / 2], raw[i]);
          dla[c] = fmaf(v[kOneHead ? 0 : c].y, bf16_lo(d), dla[c]);
          dla[c + 1] = fmaf(v[kOneHead ? 0 : c + 1].y, bf16_hi(d), dla[c + 1]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = l * kV + i;
          dla[c] = fmaf(v[kOneHead ? 0 : c].y, __fmul_rn(__uint_as_float(xw[c]), __uint_as_float(raw[i])), dla[c]);
        }
      }
    }
  }

  // The groups' partial sums meet: lanes sub, sub + kG, sub + 2 kG, ...
  // then all hold their columns' sums.
  __device__ __forceinline__ void meet(float (&acc)[kC]) const {
#pragma unroll
    for (int o = kG; o < 32; o <<= 1) {
#pragma unroll
      for (int k = 0; k < kC; ++k) acc[k] += __shfl_xor_sync(kFull, acc[k], o);
    }
  }

  // The lane's columns of an output row: stored once, or added by atomicAdd
  // into a row the wrapper zeroed where the row is split.
  __device__ __forceinline__ void store(float* __restrict__ out_row, const float (&acc)[kC], bool split) const {
    float* o = out_row + col0();
    if (!split && (hf & 3) == 0 && col0() + kC <= hf) {
#pragma unroll
      for (int k = 0; k < kC; k += 4) {
        *reinterpret_cast<float4*>(o + k) = make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        if (col0() + k < hf) {
          if (split) {
            atomicAdd(o + k, acc[k]);
          } else {
            o[k] = acc[k];
          }
        }
      }
    }
  }
};

// Runs `work(r, cnt)` for the rounds of an item of `nedges` edges starting
// at `cols` + beg, `issue(r, my, cnt)` having started each round's copies
// kStages - 1 rounds before; the round's copies have landed, for every lane
// of the warp, when `work` runs. `my` is the lane's node of the round's
// edge `lane`, loaded one round before it is used.
template <int kRound, typename Issue, typename Work>
__device__ __forceinline__ void walk_rounds(const int32_t* __restrict__ cols, int beg, int nedges, int lane,
                                            Issue&& issue, Work&& work) {
  const int nrounds = (nedges + kRound - 1) / kRound;
  auto node_of = [&](int r) {
    const int e = r * kRound + lane;
    return lane < kRound && e < nedges ? __ldg(cols + beg + e) : 0;
  };
  int my = node_of(0);
#pragma unroll
  for (int r = 0; r < kStages - 1; ++r) {
    const int next = node_of(r + 1);
    if (r < nrounds) issue(r, my, min(kRound, nedges - r * kRound));
    commit_round();
    my = next;
  }
  for (int r = 0; r < nrounds; ++r) {  // warp-uniform
    const int ri = r + kStages - 1;
    const int next = node_of(ri + 1);
    if (ri < nrounds) issue(ri, my, min(kRound, nedges - ri * kRound));
    commit_round();
    my = next;
    wait_rounds<kStages - 1>();
    __syncwarp();
    work(r, min(kRound, nedges - r * kRound));
    __syncwarp();  // before a later round's copies reuse this round's stage
  }
}

// The smallest k with 2^k >= h.
inline int log2_ceil(int h) {
  int k = 0;
  while ((1 << k) < h) ++k;
  return k;
}

// Whether the kernels take these arguments: H <= 16, H * F <= 256, a table
// of 16 B aligned rows (ld a multiple of the load's columns), and kG lanes
// of kL loads that cover the row.
inline bool geometry_ok(int h, int f, int ld, const void* table, int bf16, int g, int loads, int chunk) {
  const int v = bf16 ? 8 : 4;
  const int hf = h * f;
  return h >= 1 && h <= 16 && f >= 1 && hf <= 256 && chunk >= 1 && ld >= hf && ld % v == 0 &&
         reinterpret_cast<uintptr_t>(table) % 16 == 0 && g >= 1 && g <= 32 && (g & (g - 1)) == 0 &&
         (loads == 1 || (loads == 2 && !bf16 && g == 32)) && g * loads * v >= hf;
}

template <int G, int L>
struct Geometry {
  static constexpr int kG = G;
  static constexpr int kL = L;
};

// Calls fn(Geometry<g, loads>{}) for a geometry the kernels are built for.
template <typename T, typename Fn>
bool dispatch(int g, int loads, Fn&& fn) {
  if (loads == 2) {
    if constexpr (sizeof(T) == 4) {
      if (g == 32) {
        fn(Geometry<32, 2>{});
        return true;
      }
    }
    return false;
  }
  if (loads != 1) return false;
  switch (g) {
    case 1: fn(Geometry<1, 1>{}); return true;
    case 2: fn(Geometry<2, 1>{}); return true;
    case 4: fn(Geometry<4, 1>{}); return true;
    case 8: fn(Geometry<8, 1>{}); return true;
    case 16: fn(Geometry<16, 1>{}); return true;
    case 32: fn(Geometry<32, 1>{}); return true;
    default: return false;
  }
}

// Launches `kernel` over `num_items` items with the walk's warps a block and
// ring, allowing the block more than 48 KB of dynamic shared memory.
template <typename W, typename Kernel, typename... Args>
cudaError_t launch_walk(Kernel kernel, int num_items, int log_kh, cudaStream_t stream, Args... args) {
  const int warps = W::warps_per_block(log_kh);
  const size_t smem = W::smem_bytes(log_kh);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((num_items + warps - 1) / warps);
  kernel<<<grid, warps * 32, smem, stream>>>(args...);
  return cudaSuccess;
}

}  // namespace flash
}  // namespace stg
