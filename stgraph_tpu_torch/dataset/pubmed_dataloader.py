"""Pubmed citation network loader.

A copy of ``stgraph_tpu/dataset/pubmed_dataloader.py`` (the Cora loader's
JSON schema and cache flow at Pubmed's sizes: 19717 nodes, 88648 directed
edges, 500 TF-IDF features, 3 classes). The synthetic fallback makes the
same random calls in the same order (seed 19717), so it is identical to the
JAX package's. ``cache_dir`` overrides the cache folder, which by default
is the port's own (``~/.stgraph/dataset_cache_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from stgraph_tpu_torch.dataset.base import STGraphStaticDataset

__all__ = ["PubmedDataLoader"]

_NODES, _EDGES, _FEATS, _CLASSES = 19717, 88648, 500, 3


class PubmedDataLoader(STGraphStaticDataset):
    def __init__(
        self,
        verbose: bool = False,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "Pubmed"
        self._cache_root = cache_dir
        self._url = (
            "https://raw.githubusercontent.com/bfGraph/STGraph-Datasets/main/pubmed.json"
        )
        self._verbose = verbose
        self._acquire(redownload)
        self._process_dataset()

    # -- synthetic --------------------------------------------------------
    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(19717)
        labels = rng.integers(0, _CLASSES, _NODES)
        # Vectorized planted-community edge sampling (Pubmed is too big for
        # a per-edge Python loop): oversample, keep intra-class with p=0.7.
        need = _EDGES
        chunks = []
        seen = np.zeros(0, np.int64)
        while need > 0:
            s = rng.integers(0, _NODES, int(need * 1.5) + 64)
            intra = rng.random(len(s)) < 0.7
            d = rng.integers(0, _NODES, len(s))
            # Map intra-class picks onto same-label nodes via random shifts.
            same = np.flatnonzero(intra)
            d[same] = (s[same] + rng.integers(1, _NODES, len(same))) % _NODES
            keep = s != d
            keys = s[keep] * _NODES + d[keep]
            keys = np.setdiff1d(np.unique(keys), seen, assume_unique=True)
            seen = np.union1d(seen, keys)
            chunks.append(keys[:need])
            need = _EDGES - sum(len(c) for c in chunks)
        keys = np.concatenate(chunks)[:_EDGES]
        edges = np.stack([keys // _NODES, keys % _NODES], 1)
        proto = rng.random((_CLASSES, _FEATS)).astype(np.float32) * 0.3
        feats = proto[labels] * (rng.random((_NODES, _FEATS)) < 0.1)
        return {
            "edges": edges.tolist(),
            "features": feats.astype(float).round(4).tolist(),
            "labels": labels.tolist(),
        }

    # -- processing (same shape as the Cora loader) ------------------------
    def _process_dataset(self) -> None:
        self._edge_list = [(int(s), int(d)) for s, d in self._dataset["edges"]]
        self._all_features = np.array(self._dataset["features"], dtype=np.float32)
        self._all_targets = np.array(self._dataset["labels"]).T
        node_set = {n for e in self._edge_list for n in e}
        self.gdata["num_nodes"] = max(node_set) + 1
        self.gdata["num_edges"] = len(self._edge_list)
        self.gdata["num_feats"] = self._all_features.shape[1]
        self.gdata["num_classes"] = len(set(self._all_targets.tolist()))

    # -- accessors ---------------------------------------------------------
    def get_edges(self) -> list:
        return self._edge_list

    def get_all_features(self) -> np.ndarray:
        return self._all_features

    def get_all_targets(self) -> np.ndarray:
        return self._all_targets
