// Native host-side graph builder for stgraph_tpu_torch.
//
// The port's own copy of `build_csr`, `blocked_sizes` and `build_blocked`
// from stgraph_tpu/native/graph_builder.cpp (the port imports nothing of the
// JAX package). One-time per-graph layout work that must be fast at ogbn
// scale (10^8 edges), where numpy's lexsort costs tens of seconds.
//
//   build_csr:     counting-sort edges by (dst, src) and emit
//                  indptr/rows/cols/eids with sentinel padding.
//   build_blocked: the chunk-aligned per-row-block edge layout that the
//                  blocked SpMM kernel K10 reads (graph/blocked.py).
//
// Exposed as a C ABI for ctypes. All buffers are caller-allocated numpy
// arrays. Built at first use by stgraph_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o build/native/libgraph_builder-<hash>.so graph_builder.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
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

// Chunk-aligned blocked layout. Phase 1: compute per-block padded counts so
// the caller can allocate; phase 2 fills. `offsets_out`/`counts_out` have
// length nb = ceil(n_pad / row_block). Returns total blocked capacity.
int64_t blocked_sizes(const int32_t* indptr, int32_t n, int32_t row_block,
                      int32_t edge_chunk, int64_t* offsets_out,
                      int64_t* counts_out) {
  int32_t n_pad = ((n + row_block - 1) / row_block) * row_block;
  if (n_pad == 0) n_pad = row_block;
  int32_t nb = n_pad / row_block;
  int64_t total = 0;
  for (int32_t b = 0; b < nb; ++b) {
    int32_t lo = std::min(b * row_block, n);
    int32_t hi = std::min((b + 1) * row_block, n);
    int64_t c = indptr[hi] - indptr[lo];
    int64_t padded = ((c + edge_chunk - 1) / edge_chunk) * edge_chunk;
    offsets_out[b] = total;
    counts_out[b] = padded;
    total += padded;
  }
  if (total == 0) {
    total = edge_chunk;
    if (nb > 0) counts_out[0] = 0;
  }
  return total;
}

int build_blocked(const int32_t* indptr, const int32_t* rows,
                  const int32_t* cols, const int32_t* eids, int32_t n,
                  int64_t capacity, int32_t row_block, int32_t edge_chunk,
                  const int64_t* offsets, int64_t total, int32_t* bdst,
                  int32_t* bcols, int32_t* bperm, int32_t* beids) {
  for (int64_t i = 0; i < total; ++i) {
    bdst[i] = n;
    bcols[i] = n;
    bperm[i] = static_cast<int32_t>(capacity);
    beids[i] = static_cast<int32_t>(capacity);
  }
  int32_t n_pad = ((n + row_block - 1) / row_block) * row_block;
  if (n_pad == 0) n_pad = row_block;
  int32_t nb = n_pad / row_block;
  for (int32_t b = 0; b < nb; ++b) {
    int32_t lo = std::min(b * row_block, n);
    int32_t hi = std::min((b + 1) * row_block, n);
    int64_t s = indptr[lo];
    int64_t c = indptr[hi] - indptr[lo];
    int64_t o = offsets[b];
    std::memcpy(bdst + o, rows + s, c * sizeof(int32_t));
    std::memcpy(bcols + o, cols + s, c * sizeof(int32_t));
    std::memcpy(beids + o, eids + s, c * sizeof(int32_t));
    for (int64_t i = 0; i < c; ++i) bperm[o + i] = static_cast<int32_t>(s + i);
  }
  return 0;
}

}  // extern "C"
