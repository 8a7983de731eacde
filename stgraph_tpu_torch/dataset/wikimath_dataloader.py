"""WikiMaths temporal dataset loader.

A copy of ``stgraph_tpu/dataset/wikimath_dataloader.py`` (JSON schema
``{"edges", "weights", "time_periods", "<t>": {"y": [...]}}``; 1068 nodes,
27,079 edges, 731 timestamps). The synthetic fallback makes the same random
calls in the same order (seed 1068), so it is identical to the JAX
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
    zscore,
)
from stgraph_tpu_torch.dataset.base import STGraphTemporalDataset

__all__ = ["WikiMathDataLoader"]

_NODES, _EDGES, _T = 1068, 27079, 731


class WikiMathDataLoader(STGraphTemporalDataset):
    def __init__(
        self,
        verbose: bool = False,
        lags: int = 8,
        cutoff_time: Optional[int] = None,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "WikiMath"
        self._cache_root = cache_dir
        self._url = "https://raw.githubusercontent.com/bfGraph/STGraph-Datasets/main/wikivital_mathematics.json"
        self._verbose = verbose
        self._lags = lags
        self._cutoff_time = cutoff_time
        self._acquire(redownload)
        self._process_dataset()

    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(1068)
        edges = ring_plus_random_edges(rng, _NODES, _EDGES)
        y = np.exp(ar1_series(rng, _T, _NODES)) * 100  # visit-count-like
        data: Dict[str, Any] = {
            "edges": edges,
            "weights": rng.integers(1, 20, _EDGES).tolist(),
            "time_periods": _T,
        }
        for t in range(_T):
            data[str(t)] = {"y": y[t].tolist()}
        return data

    def _process_dataset(self) -> None:
        self.gdata["total_timestamps"] = self._total_from(self._dataset["time_periods"])
        node_set = {n for e in self._dataset["edges"] for n in e}
        self.gdata["num_nodes"] = len(node_set)
        self.gdata["num_edges"] = len(self._dataset["edges"])
        self._edge_list = [(e[0], e[1]) for e in self._dataset["edges"]]
        self._edge_weights = sort_weights_dst_src(self._dataset["edges"], self._dataset["weights"])
        targets = np.stack(
            [np.array(self._dataset[str(t)]["y"]) for t in range(self.gdata["total_timestamps"])]
        )
        std = zscore(targets)
        self._all_targets = np.array([std[i, :].T for i in range(self.gdata["total_timestamps"])])

    def get_edges(self) -> list:
        return self._edge_list

    def get_edge_weights(self) -> np.ndarray:
        return self._edge_weights

    def get_all_targets(self) -> np.ndarray:
        return self._all_targets
