"""METR-LA traffic-forecasting temporal dataset loader.

A copy of ``stgraph_tpu/dataset/metrla_dataloader.py`` (JSON schema
``{"edges", "weights", "time_periods", "<t>": [[...]...]}`` with each
timestamp's (N, C) sensor readings; 207 nodes, 1722 edges, 100 timestamps,
two channels; DCRNN-style z-score and sliding windows of
``num_timesteps_in`` inputs and ``num_timesteps_out`` targets). The
synthetic fallback makes the same random calls in the same order (seed 207),
so it is identical to the JAX package's. ``cache_dir`` overrides the cache
folder, which by default is the port's own (``~/.stgraph/dataset_cache_torch``).
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

__all__ = ["METRLADataLoader"]

_NODES, _EDGES, _T, _CHANNELS = 207, 1722, 100, 2


class METRLADataLoader(STGraphTemporalDataset):
    def __init__(
        self,
        verbose: bool = False,
        num_timesteps_in: int = 12,
        num_timesteps_out: int = 12,
        cutoff_time: Optional[int] = None,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "METRLA"
        self._cache_root = cache_dir
        self._url = "https://raw.githubusercontent.com/bfGraph/STGraph-Datasets/main/METRLA.json"
        self._verbose = verbose
        self._num_timesteps_in = num_timesteps_in
        self._num_timesteps_out = num_timesteps_out
        self._cutoff_time = cutoff_time
        self._acquire(redownload)
        self._process_dataset()

    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(207)
        speeds = 60 + 10 * ar1_series(rng, _T, _NODES)
        occupancy = np.abs(ar1_series(rng, _T, _NODES))
        data: Dict[str, Any] = {
            "edges": ring_plus_random_edges(rng, _NODES, _EDGES),
            "weights": rng.random(_EDGES).round(4).tolist(),
            "time_periods": _T,
        }
        for t in range(_T):
            data[str(t)] = np.stack([speeds[t], occupancy[t]], axis=1).tolist()
        return data

    def _process_dataset(self) -> None:
        self.gdata["total_timestamps"] = self._total_from(self._dataset["time_periods"])
        node_set = {n for e in self._dataset["edges"] for n in e}
        self.gdata["num_nodes"] = len(node_set)
        self.gdata["num_edges"] = len(self._dataset["edges"])
        self._edge_list = [(e[0], e[1]) for e in self._dataset["edges"]]
        self._edge_weights = sort_weights_dst_src(self._dataset["edges"], self._dataset["weights"])

        x = np.array(
            [self._dataset[str(t)] for t in range(self.gdata["total_timestamps"])]
        ).transpose(1, 2, 0).astype(np.float32)  # (N, C, T)
        means = np.mean(x, axis=(0, 2))
        x = x - means.reshape(1, -1, 1)
        stds = np.std(x, axis=(0, 2))
        x = x / stds.reshape(1, -1, 1)

        win = self._num_timesteps_in + self._num_timesteps_out
        features, target = [], []
        for i in range(x.shape[2] - win + 1):
            features.append(x[:, :, i : i + self._num_timesteps_in])
            target.append(x[:, 0, i + self._num_timesteps_in : i + win])
        self._all_features = np.array(features)
        self._all_targets = np.array(target)

    def get_edges(self) -> list:
        return self._edge_list

    def get_edge_weights(self) -> np.ndarray:
        return self._edge_weights

    def get_all_features(self) -> np.ndarray:
        return self._all_features

    def get_all_targets(self) -> np.ndarray:
        return self._all_targets
