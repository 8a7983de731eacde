"""OGB node-property dataset loader (ogbn-products and friends).

A copy of ``stgraph_tpu/dataset/ogb_dataloader.py`` (host numpy only): the
``.npz`` path, the raw-CSV path and the synthetic generator are verbatim, so
one seed gives both packages the same graph. One difference: the synthetic
cache file carries a ``.torch`` tag, so the two loaders never share a file.
``reorder=True`` relabels the nodes by the port's ``graph.reorder``, as the
JAX loader does by its own.

The reference has no OGB support; BASELINE config 5 requires a 3-layer GCN
on **ogbn-products** (2,449,029 nodes / 61,859,140 undirected edges =
123,718,280 directed, 100-dim features, 47 classes) edge-partitioned
across devices. This loader reads the standard OGB on-disk layouts:

  * ``<root>/ogbn_products/raw/{edge.csv.gz, node-feat.csv.gz,
    node-label.csv.gz}`` (the format ``ogb.nodeproppred`` downloads), or
  * a preprocessed ``<root>/<name>.npz`` with keys ``edge_index`` (2, E),
    ``node_feat`` (N, F), ``labels`` (N,) — much faster to parse, written
    back automatically after a CSV load;

and, when neither exists (this environment has no network egress), falls
back to a **scale-faithful synthetic graph**: the exact node/edge/feature/
class counts with a Chung-Lu power-law degree profile (alpha ~ 2.3 — the
published ogbn-products degree exponent) and community-correlated features
so a GCN trains meaningfully. ``self.synthetic`` reports which path ran;
benchmarks must print it so synthetic numbers are never mistaken for real
ones.
"""

from __future__ import annotations

import gzip
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["OgbNodeDataLoader", "OGBN_PRODUCTS_STATS"]

# name -> (num_nodes, num_directed_edges, num_feats, num_classes)
OGBN_PRODUCTS_STATS = (2_449_029, 123_718_280, 100, 47)
_KNOWN = {
    "ogbn-products": OGBN_PRODUCTS_STATS,
    "ogbn-arxiv": (169_343, 1_166_243, 128, 40),
}


class OgbNodeDataLoader:
    """OGB node-classification graphs from local files or synthesis.

    Args:
      name: OGB dataset name (``ogbn-products``, ``ogbn-arxiv``).
      root: directory holding either ``<name>.npz`` or the OGB raw layout
        (default ``~/.stgraph/dataset_cache/ogb``).
      scale: shrink factor for the synthetic fallback (1.0 = full size);
        lets tests exercise the exact code path in seconds.
      allow_synthetic: raise instead of synthesizing when False.
      reorder: relabel the nodes by label propagation
        (``graph.reorder.locality_order``) so that communities get
        contiguous ids: the edge index is relabelled and the features and
        labels permuted; ``node_order`` then holds the order (``order[k]``
        the old id of new node ``k``), and is None otherwise.
    """

    def __init__(
        self,
        name: str = "ogbn-products",
        root: Optional[str] = None,
        scale: float = 1.0,
        allow_synthetic: bool = True,
        seed: int = 0,
        reorder: bool = False,
    ) -> None:
        if name not in _KNOWN:
            raise ValueError(f"unknown OGB dataset {name!r}")
        self.name = name
        self.synthetic = False
        self.gdata: Dict[str, Any] = {}
        root = root or os.path.join(
            os.path.expanduser("~"), ".stgraph", "dataset_cache", "ogb"
        )
        self._root = root
        npz = os.path.join(root, f"{name}.npz")
        rawdir = os.path.join(root, name.replace("-", "_"), "raw")
        if os.path.exists(npz):
            data = np.load(npz)
            self._edge_index = data["edge_index"].astype(np.int64)
            self._feat = data["node_feat"].astype(np.float32)
            self._labels = data["labels"].astype(np.int64).reshape(-1)
        elif os.path.isdir(rawdir):
            self._edge_index, self._feat, self._labels = self._load_raw(rawdir)
            os.makedirs(root, exist_ok=True)
            np.savez(
                npz,
                edge_index=self._edge_index,
                node_feat=self._feat,
                labels=self._labels,
            )
        elif allow_synthetic:
            self.synthetic = True
            # Full-scale synthesis costs minutes (Chung-Lu searchsorted over
            # 1.2e8 draws); cache the result keyed by generator version.
            syn_npz = os.path.join(
                root, f"{name}.synthetic-v2.scale{scale}.seed{seed}.torch.npz"
            )
            if os.path.exists(syn_npz):
                data = np.load(syn_npz)
                self._edge_index = data["edge_index"]
                self._feat = data["node_feat"]
                self._labels = data["labels"]
            else:
                self._edge_index, self._feat, self._labels = self._synthesize(
                    *_KNOWN[name], scale=scale, seed=seed
                )
                if scale >= 0.25:  # only cache the expensive sizes
                    try:
                        os.makedirs(root, exist_ok=True)
                        np.savez(
                            syn_npz,
                            edge_index=self._edge_index,
                            node_feat=self._feat,
                            labels=self._labels,
                        )
                    except OSError:
                        pass
        else:
            raise FileNotFoundError(
                f"no OGB data at {npz} or {rawdir} and allow_synthetic=False"
            )
        n = int(self._feat.shape[0])
        self.node_order = None
        if reorder:
            from stgraph_tpu_torch.graph.reorder import (
                inverse_permutation,
                locality_order,
            )

            order = locality_order(self._edge_index[0], self._edge_index[1], n)
            new_id = inverse_permutation(order).astype(np.int64)
            self._edge_index = new_id[self._edge_index]
            self._feat = self._feat[order]
            self._labels = self._labels[order]
            self.node_order = order
        self.gdata = {
            "num_nodes": n,
            "num_edges": int(self._edge_index.shape[1]),
            "num_feats": int(self._feat.shape[1]),
            "num_classes": int(self._labels.max()) + 1,
        }

    # -- real data ---------------------------------------------------------
    @staticmethod
    def _load_raw(rawdir: str):
        """Parse OGB's raw CSV layout (edge.csv.gz etc.)."""

        def read_csv_gz(fname, dtype):
            path = os.path.join(rawdir, fname)
            with gzip.open(path, "rt") as fh:
                return np.loadtxt(fh, delimiter=",", dtype=dtype)

        edges = read_csv_gz("edge.csv.gz", np.int64)  # (E_undirected, 2)
        feat = read_csv_gz("node-feat.csv.gz", np.float32)
        labels = read_csv_gz("node-label.csv.gz", np.int64).reshape(-1)
        # OGB node graphs are undirected: symmetrize to directed edges.
        edge_index = np.concatenate([edges, edges[:, ::-1]], axis=0).T
        return edge_index.astype(np.int64), feat, labels

    # -- synthetic fallback --------------------------------------------------
    @staticmethod
    def _synthesize(
        n: int, e: int, f: int, classes: int, scale: float, seed: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Degree-corrected block-model graph (power-law + communities).

        Two measured properties of ogbn-products matter for benchmarks and
        are both reproduced:

        * **heavy-tailed degrees** — Chung-Lu weights w_i ∝ i^(-1/(alpha-1))
          with alpha=2.3 (the published products degree exponent); endpoint
          probability ∝ w preserves the hub structure that stresses
          edge-partition balancing and halo sizing;
        * **community clustering** — products is a co-purchase network with
          ~0.8 label homophily; here a degree-corrected SBM draws
          ``p_intra`` (0.8) of each node's edges inside its community. This is
          what makes gather-locality reordering (graph/reorder.py)
          meaningful: a uniform-random graph has no locality to recover.

        Node ids are shuffled so neither degree nor community is encoded in
        the id (locality/balance must not come for free); labels follow
        communities so a GCN trains meaningfully.
        """
        rng = np.random.default_rng(seed)
        n = max(int(n * scale), 64)
        e = max(int(e * scale), 256)
        alpha = 2.3
        p_intra = 0.8
        # ~600 nodes per community (a community's feature rows ≈ 0.25 MB —
        # the locality target; products' co-purchase clusters are
        # hundreds of items), between 4 and 4096 communities.
        k = int(np.clip(n // 600, 4, 4096))

        # Virtual layout: nodes sorted by (community, rank); communities are
        # contiguous ranges. The global weight sequence is dealt round-robin
        # so every community gets a similar degree profile.
        sizes = np.full(k, n // k, np.int64)
        sizes[: n % k] += 1
        offsets = np.zeros(k + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        w_sorted = (np.arange(1, n + 1, dtype=np.float64)) ** (
            -1.0 / (alpha - 1.0)
        )
        # Deal rank r of the sorted weights to community r % k, position
        # r // k — i.e. virtual node offsets[c] + j has global rank j*k + c.
        comm_of = np.repeat(np.arange(k), sizes)
        j_in_comm = np.arange(n) - offsets[comm_of]
        w = w_sorted[np.minimum(j_in_comm * k + comm_of, n - 1)]
        cdf = np.cumsum(w)
        total = cdf[-1]

        n_intra = int(e * p_intra)
        # Intra edges: community ∝ its weight mass, endpoints from the
        # community's own weight slice (one global searchsorted each).
        mass = np.add.reduceat(w, offsets[:-1])
        comm_cdf = np.cumsum(mass) / mass.sum()
        ec = np.searchsorted(comm_cdf, rng.random(n_intra))
        lo = np.where(offsets[ec] > 0, cdf[offsets[ec] - 1], 0.0)
        span = cdf[offsets[ec + 1] - 1] - lo
        src_v = np.searchsorted(cdf, lo + span * rng.random(n_intra))
        dst_v = np.searchsorted(cdf, lo + span * rng.random(n_intra))
        # Inter edges: global Chung-Lu draw.
        n_inter = e - n_intra
        src_g = np.searchsorted(cdf, total * rng.random(n_inter))
        dst_g = np.searchsorted(cdf, total * rng.random(n_inter))
        perm = rng.permutation(n)
        src = perm[np.clip(np.concatenate([src_v, src_g]), 0, n - 1)]
        dst = perm[np.clip(np.concatenate([dst_v, dst_g]), 0, n - 1)]
        edge_index = np.stack([src, dst]).astype(np.int64)

        # Labels follow communities (with 10% noise) -> homophilous graph.
        comm_labels = rng.integers(0, classes, k)
        labels = comm_labels[comm_of]
        flip = rng.random(n) < 0.1
        labels = np.where(flip, rng.integers(0, classes, n), labels)
        labels_shuffled = np.empty(n, np.int64)
        labels_shuffled[perm] = labels
        centroids = rng.standard_normal((classes, f)).astype(np.float32)
        feat = centroids[labels_shuffled] + 0.5 * rng.standard_normal(
            (n, f)
        ).astype(np.float32)
        return edge_index, feat.astype(np.float32), labels_shuffled

    # -- accessors (reference-style) ----------------------------------------
    def get_edges(self) -> np.ndarray:
        """(E, 2) directed (src, dst) pairs."""
        return self._edge_index.T

    def get_edge_index(self) -> np.ndarray:
        """(2, E) directed edge index."""
        return self._edge_index

    def get_all_features(self) -> np.ndarray:
        return self._feat

    def get_all_targets(self) -> np.ndarray:
        return self._labels
