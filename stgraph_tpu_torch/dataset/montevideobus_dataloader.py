"""Montevideo bus passenger-inflow temporal dataset loader.

A copy of ``stgraph_tpu/dataset/montevideobus_dataloader.py`` (JSON schema
``{"edges", "weights", "nodes": [{"y": [...], "X": {"y": [...]}}]}``; 675
nodes, 690 edges, 744 timestamps). The synthetic fallback makes the same
random calls in the same order (seed 675), so it is identical to the JAX
package's. ``cache_dir`` overrides the cache folder, which by default is the
port's own (``~/.stgraph/dataset_cache_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from stgraph_tpu_torch.dataset._temporal_common import (
    ar1_series,
    ring_plus_random_edges,
    sort_weights_dst_src,
)
from stgraph_tpu_torch.dataset.base import STGraphTemporalDataset

__all__ = ["MontevideoBusDataLoader"]

_NODES, _EDGES, _T = 675, 690, 744


class MontevideoBusDataLoader(STGraphTemporalDataset):
    def __init__(
        self,
        verbose: bool = False,
        lags: int = 4,
        cutoff_time: Optional[int] = None,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "MontevideoBus"
        self._cache_root = cache_dir
        self._url = "https://raw.githubusercontent.com/bfGraph/STGraph-Datasets/main/montevideobus.json"
        self._verbose = verbose
        self._lags = lags
        self._cutoff_time = cutoff_time
        self._acquire(redownload)
        self._process_dataset()

    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(675)
        y = np.abs(ar1_series(rng, _T, _NODES) * 50)
        nodes = [{"y": y[:, i].tolist(), "X": {"y": y[:, i].tolist()}} for i in range(_NODES)]
        return {
            "edges": ring_plus_random_edges(rng, _NODES, _EDGES),
            "weights": rng.random(_EDGES).round(4).tolist(),
            "nodes": nodes,
        }

    def _process_dataset(self) -> None:
        self.gdata["total_timestamps"] = self._total_from(len(self._dataset["nodes"][0]["y"]))
        node_set = {n for e in self._dataset["edges"] for n in e}
        self.gdata["num_nodes"] = len(node_set)
        self.gdata["num_edges"] = len(self._dataset["edges"])
        self._edge_list = [(e[0], e[1]) for e in self._dataset["edges"]]
        self._edge_weights = sort_weights_dst_src(self._dataset["edges"], self._dataset["weights"])
        t = self.gdata["total_timestamps"]

        feats = np.stack([np.array(node["X"]["y"][:t]) for node in self._dataset["nodes"]]).T  # (T, N)
        feats = (feats - feats.mean(axis=0)) / (feats.std(axis=0) + 1e-10)
        self._all_features = np.array([feats[i : i + self._lags, :].T for i in range(len(feats) - self._lags)])

        targets = np.stack([np.array(node["y"][:t]) for node in self._dataset["nodes"]]).T
        targets = (targets - targets.mean(axis=0)) / (targets.std(axis=0) + 1e-10)
        self._all_targets = np.array([targets[i + self._lags, :].T for i in range(len(targets) - self._lags)])

    def get_edges(self) -> list:
        return self._edge_list

    def get_edge_weights(self) -> np.ndarray:
        return self._edge_weights

    def get_all_features(self) -> np.ndarray:
        return self._all_features

    def get_all_targets(self) -> np.ndarray:
        return self._all_targets
