"""Windmill energy-output temporal dataset loader.

A copy of ``stgraph_tpu/dataset/windmilloutput_dataloader.py`` (JSON schema
``{"edges", "weights", "time_periods", "block"}``; sizes large = 319,
medium = 26, small = 11 nodes on complete graphs with self loops, 17472
timestamps). The synthetic fallback makes the same random calls in the same
order (seed = the node count), so it is identical to the JAX package's: it
holds ``min(17472, 4096)`` timestamps, or ``max(cutoff_time, 64)`` when a
cutoff is given. ``cache_dir`` overrides the cache folder, which by default
is the port's own (``~/.stgraph/dataset_cache_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from stgraph_tpu_torch.dataset._temporal_common import ar1_series, sort_weights_dst_src, zscore
from stgraph_tpu_torch.dataset.base import STGraphTemporalDataset

__all__ = ["WindmillOutputDataLoader"]

_SIZES = {"large": 319, "medium": 26, "small": 11}
_T = 17472


class WindmillOutputDataLoader(STGraphTemporalDataset):
    def __init__(
        self,
        verbose: bool = False,
        lags: int = 8,
        cutoff_time: Optional[int] = None,
        size: str = "large",
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        if size not in _SIZES:
            raise ValueError(f"size must be one of {sorted(_SIZES)}")
        self.name = "WindMill_" + size
        self._cache_root = cache_dir
        self._size = size
        size_urls = {
            "large": "https://graphmining.ai/temporal_datasets/windmill_output.json",
            "medium": "https://graphmining.ai/temporal_datasets/windmill_output_medium.json",
            "small": "https://graphmining.ai/temporal_datasets/windmill_output_small.json",
        }
        self._url = size_urls[size]
        self._verbose = verbose
        self._lags = lags
        self._cutoff_time = cutoff_time
        self._acquire(redownload)
        self._process_dataset()

    def _generate_synthetic(self) -> Dict[str, Any]:
        n = _SIZES[self._size]
        rng = np.random.default_rng(n)
        # the complete directed graph with self loops: the real dataset has
        # exactly n^2 edges a size
        edges = [[i, j] for i in range(n) for j in range(n)]
        t = min(_T, 4096) if self._cutoff_time is None else min(_T, max(self._cutoff_time, 64))
        return {
            "edges": edges,
            "weights": rng.random(len(edges)).round(4).tolist(),
            "time_periods": t,
            "block": np.abs(ar1_series(rng, t, n)).tolist(),
        }

    def _process_dataset(self) -> None:
        self.gdata["total_timestamps"] = self._total_from(self._dataset["time_periods"])
        node_set = {n for e in self._dataset["edges"] for n in e}
        self.gdata["num_nodes"] = len(node_set)
        self.gdata["num_edges"] = len(self._dataset["edges"])
        self._edge_list = [(e[0], e[1]) for e in self._dataset["edges"]]
        self._edge_weights = sort_weights_dst_src(self._dataset["edges"], self._dataset["weights"])
        stacked = np.stack(self._dataset["block"])[: self.gdata["total_timestamps"]]
        std = zscore(stacked)
        self._all_targets = [std[i, :].T for i in range(self.gdata["total_timestamps"])]

    def get_edges(self) -> list:
        return self._edge_list

    def get_edge_weights(self) -> np.ndarray:
        return self._edge_weights

    def get_all_targets(self) -> list:
        return self._all_targets
