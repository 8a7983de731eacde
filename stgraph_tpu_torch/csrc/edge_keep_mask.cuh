// The attention-dropout keep factor of one (edge, head): the stateless hash
// of the JAX package's flash_gat.edge_keep_mask
// (stgraph_tpu/ops/flash_gat.py:109-139), bit for bit, computed in
// registers where K8 and K9 form the edge's weight. The TPU kernels stream
// the mask as an (H, E) f32 plane that XLA builds before each pass (one a
// pass, 3.96 GB at ogbn-products size with 8 heads); here nothing is read
// but the (src, dst) pair the kernel already holds.
//
//   k = src * 0x9E3779B9 ^ dst * 0x85EBCA6B ^ (seed + 0x27D4EB2F)
//   x = k + head * 0x165667B1, then murmur3's finaliser:
//   x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13; x *= 0xC2B2AE35;
//   x ^= x >> 16
//   keep if (x >> 8) * 2^-24 >= rate: the factor is 1 / (1 - rate), else 0
//
// in uint32 arithmetic (every product and sum wraps mod 2^32). The hash
// sees (src, dst), not the edge's position, so the forward CSR and its
// transpose draw the same mask without a permutation. `rate` is the f32
// rounding of the rate and `scale` the f32 rounding of 1 / (1 - rate), both
// rounded on the host as the JAX function rounds them.

#pragma once

#include <cstdint>

namespace stg {

__device__ __forceinline__ float edge_keep(uint32_t src, uint32_t dst,
                                           uint32_t seed, uint32_t head,
                                           float rate, float scale) {
  uint32_t x = ((src * 0x9E3779B9u) ^ (dst * 0x85EBCA6Bu) ^ (seed + 0x27D4EB2Fu)) +
               head * 0x165667B1u;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  // x >> 8 < 2^24: exact in f32, and so is the scaling by 2^-24.
  const float u = static_cast<float>(x >> 8) * (1.0f / 16777216.0f);
  return u >= rate ? scale : 0.f;
}

}  // namespace stg
