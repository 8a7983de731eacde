// Native host-side CSR builder for stgraph_tpu_torch.
//
// The port's own copy of `build_csr` from stgraph_tpu/native/graph_builder.cpp
// (the port imports nothing of the JAX package). One-time per-graph layout
// work that must be fast at ogbn scale (10^8 edges), where numpy's lexsort
// costs tens of seconds.
//
// Exposed as a C ABI for ctypes. All buffers are caller-allocated numpy
// arrays. Built at first use by stgraph_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o build/native/libgraph_builder-<hash>.so graph_builder.cpp

#include <algorithm>
#include <cstdint>
#include <vector>

extern "C" {

// Sort edges by (dst, src) with two stable counting sorts; fill padded
// outputs. rows/cols/eids have length `capacity`; indptr length n+1.
// Returns 0 on success.
int build_csr(const int32_t* src, const int32_t* dst, int64_t e,
              int32_t n, int64_t capacity, int32_t* indptr, int32_t* rows,
              int32_t* cols, int32_t* eids) {
  if (capacity < e) return 1;
  std::vector<int64_t> count(static_cast<size_t>(n) + 1, 0);
  // Pass 1: stable counting sort by src.
  for (int64_t i = 0; i < e; ++i) count[src[i]]++;
  std::vector<int64_t> pos(static_cast<size_t>(n) + 1, 0);
  for (int32_t v = 1; v <= n; ++v) pos[v] = pos[v - 1] + count[v - 1];
  std::vector<int32_t> order1(e);
  for (int64_t i = 0; i < e; ++i) order1[pos[src[i]]++] = static_cast<int32_t>(i);
  // Pass 2: stable counting sort by dst over the src-sorted order.
  std::fill(count.begin(), count.end(), 0);
  for (int64_t i = 0; i < e; ++i) count[dst[i]]++;
  std::fill(pos.begin(), pos.end(), 0);
  for (int32_t v = 1; v <= n; ++v) pos[v] = pos[v - 1] + count[v - 1];
  for (int64_t i = 0; i < e; ++i) {
    int32_t orig = order1[i];
    int64_t p = pos[dst[orig]]++;
    rows[p] = dst[orig];
    cols[p] = src[orig];
    eids[p] = orig;
  }
  // Padding sentinels.
  for (int64_t i = e; i < capacity; ++i) {
    rows[i] = n;
    cols[i] = n;
    eids[i] = static_cast<int32_t>(capacity);
  }
  // indptr from dst counts.
  indptr[0] = 0;
  for (int32_t v = 0; v < n; ++v)
    indptr[v + 1] = indptr[v] + static_cast<int32_t>(count[v]);
  return 0;
}

}  // extern "C"
