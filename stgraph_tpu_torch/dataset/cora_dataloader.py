"""Cora citation network loader.

A copy of ``stgraph_tpu/dataset/cora_dataloader.py`` (same URL/cache JSON
schema: ``{"edges", "features", "labels"}``; same ``gdata`` keys). The
synthetic fallback makes the same random calls in the same order, so it is
identical to the JAX package's: Cora's exact sizes (2708 nodes, 10556
edges, 1433 binary word features, 7 classes) with a planted community
structure so GCN training remains a meaningful benchmark offline.
``cache_dir`` overrides the cache folder.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from stgraph_tpu_torch.dataset.base import STGraphStaticDataset, synthetic_graph

__all__ = ["CoraDataLoader"]

_NODES, _EDGES, _FEATS, _CLASSES = 2708, 10556, 1433, 7


class CoraDataLoader(STGraphStaticDataset):
    def __init__(
        self,
        verbose: bool = False,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "Cora"
        self._cache_root = cache_dir
        self._url = (
            "https://raw.githubusercontent.com/bfGraph/STGraph-Datasets/main/cora.json"
        )
        self._verbose = verbose
        self._train_mask = None
        self._test_mask = None
        self._acquire(redownload)
        self._process_dataset()

    # -- synthetic --------------------------------------------------------
    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(2708)
        labels = rng.integers(0, _CLASSES, _NODES)
        # Planted communities: intra-class edges dominate, like citations.
        edges = set((int(i), int((i + 1) % _NODES)) for i in range(_NODES))
        while len(edges) < _EDGES:
            s = int(rng.integers(0, _NODES))
            if rng.random() < 0.7:
                pool = np.flatnonzero(labels == labels[s])
                d = int(pool[rng.integers(0, len(pool))])
            else:
                d = int(rng.integers(0, _NODES))
            if s != d:
                edges.add((s, d))
        # Class-dependent sparse binary word vectors.
        proto = rng.random((_CLASSES, _FEATS)) < 0.03
        feats = np.zeros((_NODES, _FEATS), dtype=np.int8)
        for i in range(_NODES):
            keep = rng.random(_FEATS) < 0.8
            noise = rng.random(_FEATS) < 0.005
            feats[i] = (proto[labels[i]] & keep) | noise
        return {
            "edges": [list(e) for e in sorted(edges)][:_EDGES],
            "features": feats.tolist(),
            "labels": labels.tolist(),
        }

    # -- processing (mirrors reference ``_process_dataset``) ---------------
    def _process_dataset(self) -> None:
        self._set_edge_info()
        self._set_targets_and_features()
        self._set_graph_attributes()

    def _set_edge_info(self) -> None:
        self._edge_list = [(int(s), int(d)) for s, d in self._dataset["edges"]]

    def _set_targets_and_features(self) -> None:
        self._all_features = np.array(self._dataset["features"], dtype=np.float32)
        self._all_targets = np.array(self._dataset["labels"]).T

    def _set_graph_attributes(self) -> None:
        node_set = {n for e in self._edge_list for n in e}
        self.gdata["num_nodes"] = len(node_set)
        self.gdata["num_edges"] = len(self._edge_list)
        self.gdata["num_feats"] = len(self._all_features[0])
        self.gdata["num_classes"] = len(set(self._all_targets.tolist()))

    # -- accessors ---------------------------------------------------------
    def get_edges(self) -> list:
        return self._edge_list

    def get_all_features(self) -> np.ndarray:
        return self._all_features

    def get_all_targets(self) -> np.ndarray:
        return self._all_targets
