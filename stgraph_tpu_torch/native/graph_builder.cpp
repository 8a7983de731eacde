// Native host-side graph builder for stgraph_tpu_torch.
//
// The port's own copy of `build_csr`, `blocked_sizes`, `build_blocked` and
// `reorder_locality` from stgraph_tpu/native/graph_builder.cpp (the port imports nothing of the
// JAX package). One-time per-graph layout work that must be fast at ogbn
// scale (10^8 edges), where numpy's lexsort costs tens of seconds.
//
//   build_csr:     counting-sort edges by (dst, src) and emit
//                  indptr/rows/cols/eids with sentinel padding.
//   build_blocked: the chunk-aligned per-row-block edge layout that the
//                  blocked SpMM kernel K10 reads (graph/blocked.py).
//   reorder_locality: the label-propagation node order of graph/reorder.py.
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

// Label-propagation node order for the gather's locality (graph/reorder.py).
//
// The SpMM kernels gather one feature row per edge; at ogbn-products size
// the table is far larger than the card's L2, so with ids that say nothing
// of the graph's structure nearly every row comes from device memory.
// Relabelling the nodes so that each community occupies a contiguous id
// range shrinks the rows a CSR region touches to about one community's.
//
// Synchronous label propagation over both directions of every edge with
// both ends in [0, n): each node adopts the most frequent label among its
// neighbours, ties to the smaller label, at most 8 rounds, stopping early
// when no label changes; then a stable counting sort by (label, id).
// order_out[k] is the old id of the node placed at new position k.
// O(rounds * E), with each node's label counts kept by a stamp per
// (round, node) so nothing is cleared between nodes; about 8 bytes an edge
// of extra memory.
int reorder_locality(const int32_t* src, const int32_t* dst, int64_t e,
                     int32_t n, int32_t* order_out) {
  if (n <= 0) return 0;
  // undirected adjacency over both edge directions
  std::vector<int64_t> deg(static_cast<size_t>(n) + 1, 0);
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] >= 0 && src[i] < n && dst[i] >= 0 && dst[i] < n) {
      deg[src[i]]++;
      deg[dst[i]]++;
    }
  }
  std::vector<int64_t> indptr(static_cast<size_t>(n) + 1, 0);
  for (int32_t v = 0; v < n; ++v) indptr[v + 1] = indptr[v] + deg[v];
  std::vector<int32_t> adj(static_cast<size_t>(indptr[n]));
  std::vector<int64_t> fill(indptr.begin(), indptr.end() - 1);
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] >= 0 && src[i] < n && dst[i] >= 0 && dst[i] < n) {
      adj[fill[src[i]]++] = dst[i];
      adj[fill[dst[i]]++] = src[i];
    }
  }
  std::vector<int32_t> label(static_cast<size_t>(n));
  std::vector<int32_t> next(static_cast<size_t>(n));
  for (int32_t v = 0; v < n; ++v) label[v] = v;
  std::vector<int64_t> stamp(static_cast<size_t>(n), -1);
  std::vector<int32_t> cnt(static_cast<size_t>(n), 0);
  constexpr int kRounds = 8;
  for (int r = 0; r < kRounds; ++r) {
    int64_t changed = 0;
    for (int32_t v = 0; v < n; ++v) {
      const int64_t token = static_cast<int64_t>(r) * n + v;  // one per (round, node)
      int32_t best = label[v];
      int32_t bestc = 0;
      for (int64_t j = indptr[v]; j < indptr[v + 1]; ++j) {
        const int32_t l = label[adj[j]];
        if (stamp[l] != token) {
          stamp[l] = token;
          cnt[l] = 0;
        }
        const int32_t c = ++cnt[l];
        if (c > bestc || (c == bestc && l < best)) {
          bestc = c;
          best = l;
        }
      }
      next[v] = best;
      changed += (best != label[v]);
    }
    label.swap(next);
    if (changed == 0) break;
  }
  // stable counting sort by label: the nodes in (label, id) order
  std::vector<int64_t> loff(static_cast<size_t>(n) + 1, 0);
  for (int32_t v = 0; v < n; ++v) loff[label[v] + 1]++;
  for (int32_t l = 0; l < n; ++l) loff[l + 1] += loff[l];
  for (int32_t v = 0; v < n; ++v) order_out[loff[label[v]]++] = v;
  return 0;
}

}  // extern "C"
