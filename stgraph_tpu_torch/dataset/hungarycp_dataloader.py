"""Hungary chickenpox temporal dataset loader.

A copy of ``stgraph_tpu/dataset/hungarycp_dataloader.py`` (JSON schema
``{"edges", "FX"}``; 20 nodes, 102 edges, 521 timestamps; unit edge
weights). The synthetic fallback makes the same random calls in the same
order (seed 20), so it is identical to the JAX package's. ``cache_dir``
overrides the cache folder, which by default is the port's own
(``~/.stgraph/dataset_cache_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from stgraph_tpu_torch.dataset._temporal_common import ar1_series, ring_plus_random_edges
from stgraph_tpu_torch.dataset.base import STGraphTemporalDataset

__all__ = ["HungaryCPDataLoader"]

_NODES, _EDGES, _T = 20, 102, 521


class HungaryCPDataLoader(STGraphTemporalDataset):
    def __init__(
        self,
        verbose: bool = False,
        lags: int = 4,
        cutoff_time: Optional[int] = None,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "HungaryCP"
        self._cache_root = cache_dir
        self._url = "https://raw.githubusercontent.com/bfGraph/STGraph-Datasets/main/HungaryCP.json"
        self._verbose = verbose
        self._lags = lags
        self._cutoff_time = cutoff_time
        self._acquire(redownload)
        self._process_dataset()

    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(20)
        return {
            "edges": ring_plus_random_edges(rng, _NODES, _EDGES),
            "FX": np.abs(ar1_series(rng, _T, _NODES) * 10).tolist(),
        }

    def _process_dataset(self) -> None:
        self.gdata["total_timestamps"] = self._total_from(len(self._dataset["FX"]))
        node_set = {n for e in self._dataset["edges"] for n in e}
        self.gdata["num_nodes"] = len(node_set)
        self.gdata["num_edges"] = len(self._dataset["edges"])
        self._edge_list = [(e[0], e[1]) for e in self._dataset["edges"]]
        self._edge_weights = np.ones(self.gdata["num_edges"])
        stacked = np.array(self._dataset["FX"])[: self.gdata["total_timestamps"]]
        self._all_targets = [
            stacked[i + self._lags, :].T for i in range(self.gdata["total_timestamps"] - self._lags)
        ]

    def get_edges(self) -> list:
        return self._edge_list

    def get_edge_weights(self) -> np.ndarray:
        return self._edge_weights

    def get_all_targets(self) -> list:
        return self._all_targets
