"""PedalMe London deliveries temporal dataset loader.

A copy of ``stgraph_tpu/dataset/pedalme_dataloader.py`` (JSON schema
``{"edges", "weights", "time_periods", "<t>": [...]}``; 15 nodes, 225
edges, 36 timestamps). The synthetic fallback makes the same random calls in
the same order (seed 15), so it is identical to the JAX package's.
``cache_dir`` overrides the cache folder, which by default is the port's own
(``~/.stgraph/dataset_cache_torch``).
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

__all__ = ["PedalMeDataLoader"]

_NODES, _EDGES, _T = 15, 225, 36


class PedalMeDataLoader(STGraphTemporalDataset):
    def __init__(
        self,
        verbose: bool = False,
        lags: int = 4,
        cutoff_time: Optional[int] = None,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "PedalMe"
        self._cache_root = cache_dir
        self._url = "https://raw.githubusercontent.com/bfGraph/STGraph-Datasets/main/pedalme.json"
        self._verbose = verbose
        self._lags = lags
        self._cutoff_time = cutoff_time
        self._acquire(redownload)
        self._process_dataset()

    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(15)
        y = np.abs(ar1_series(rng, _T, _NODES))
        data: Dict[str, Any] = {
            "edges": ring_plus_random_edges(rng, _NODES, _EDGES),
            "weights": rng.random(_EDGES).round(4).tolist(),
            "time_periods": _T,
        }
        for t in range(_T):
            data[str(t)] = y[t].tolist()
        return data

    def _process_dataset(self) -> None:
        self.gdata["total_timestamps"] = self._total_from(self._dataset["time_periods"])
        node_set = {n for e in self._dataset["edges"] for n in e}
        self.gdata["num_nodes"] = len(node_set)
        self.gdata["num_edges"] = len(self._dataset["edges"])
        self._edge_list = [(e[0], e[1]) for e in self._dataset["edges"]]
        self._edge_weights = sort_weights_dst_src(self._dataset["edges"], self._dataset["weights"])
        stacked = np.stack(
            [np.array(self._dataset[str(t)]) for t in range(self.gdata["total_timestamps"])]
        )
        self._all_targets = np.array(
            [stacked[i + self._lags, :].T for i in range(stacked.shape[0] - self._lags)]
        )

    def get_edges(self) -> list:
        return self._edge_list

    def get_edge_weights(self) -> np.ndarray:
        return self._edge_weights

    def get_all_targets(self) -> np.ndarray:
        return self._all_targets
