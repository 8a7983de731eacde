"""England-COVID dynamic (DTDG) dataset loader.

A copy of ``stgraph_tpu/dataset/england_covid_dataloader.py`` (JSON schema
``{"edge_mapping": {"edge_index": {"<t>": [[s, d], ...]}, "edge_weight":
{"<t>": [...]}}, "y": [[...]], "time_periods": 61}``; 129 nodes,
per-timestamp weighted edge lists, lags-windowed features). The synthetic
fallback makes the same random calls in the same order (seed 129), so it is
identical to the JAX package's. ``cache_dir`` overrides the cache folder,
which by default is the port's own (``~/.stgraph/dataset_cache_torch``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from stgraph_tpu_torch.dataset._temporal_common import ar1_series
from stgraph_tpu_torch.dataset.base import STGraphDynamicDataset

__all__ = ["EnglandCovidDataLoader"]

_NODES, _T = 129, 61


class EnglandCovidDataLoader(STGraphDynamicDataset):
    def __init__(
        self,
        verbose: bool = False,
        lags: int = 8,
        cutoff_time: Optional[int] = None,
        redownload: bool = False,
        cache_dir: Optional[str] = None,
    ) -> None:
        super().__init__()
        self.name = "England_COVID"
        self._cache_root = cache_dir
        self._url = "https://raw.githubusercontent.com/benedekrozemberczki/pytorch_geometric_temporal/master/dataset/england_covid.json"
        self._verbose = verbose
        self._lags = lags
        self._cutoff_time = cutoff_time
        self._acquire(redownload)
        self._process_dataset()

    def _generate_synthetic(self) -> Dict[str, Any]:
        rng = np.random.default_rng(129)
        edge_index: Dict[str, list] = {}
        edge_weight: Dict[str, list] = {}
        # mobility graph: a stable backbone and per-timestamp churn
        backbone = {
            (int(rng.integers(0, _NODES)), int(rng.integers(0, _NODES)))
            for _ in range(700)
        }
        backbone |= {(i, (i + 1) % _NODES) for i in range(_NODES)}
        for t in range(_T):
            extra = {
                (int(rng.integers(0, _NODES)), int(rng.integers(0, _NODES)))
                for _ in range(150)
            }
            drop = rng.random(len(backbone)) < 0.1
            kept = {e for e, d in zip(sorted(backbone), drop) if not d}
            edges = sorted(kept | extra)
            edge_index[str(t)] = [list(e) for e in edges]
            edge_weight[str(t)] = rng.random(len(edges)).round(5).tolist()
        y = np.abs(ar1_series(rng, _T, _NODES) * 5)
        return {
            "edge_mapping": {"edge_index": edge_index, "edge_weight": edge_weight},
            "y": y.tolist(),
            "time_periods": _T,
        }

    def _process_dataset(self) -> None:
        self.gdata["total_timestamps"] = self._total_from(self._dataset["time_periods"])
        self._set_targets_and_features()
        self._set_edge_info()
        self._presort_edge_weights()

    def _set_targets_and_features(self) -> None:
        stacked = np.array(self._dataset["y"])
        std = (stacked - np.mean(stacked, axis=0)) / (np.std(stacked, axis=0) + 1e-10)
        t = self.gdata["total_timestamps"]
        self._all_features = [std[i : i + self._lags, :].T for i in range(t - self._lags)]
        self._all_targets = [std[i + self._lags, :].T for i in range(t - self._lags)]

    def _set_edge_info(self) -> None:
        self._edge_list: List[list] = []
        self._edge_weights: List[list] = []
        for t in range(self.gdata["total_timestamps"]):
            te = [(e[0], e[1]) for e in self._dataset["edge_mapping"]["edge_index"][str(t)]]
            tw = list(self._dataset["edge_mapping"]["edge_weight"][str(t)])
            self._edge_list.append(te)
            self._edge_weights.append(tw)
            self.gdata["num_edges"][str(t)] = len(te)
            self.gdata["num_nodes"][str(t)] = len({n for e in te for n in e})

    def _presort_edge_weights(self) -> None:
        """Sort each timestamp's edges by (dst, src), the CSR eid order."""
        edges_out, weights_out = [], []
        for te, tw in zip(self._edge_list, self._edge_weights):
            comb = sorted(zip(te, tw), key=lambda x: (x[0][1], x[0][0]))
            edges_out.append([e for e, _ in comb])
            weights_out.append(np.array([w for _, w in comb]))
        self._edge_list = edges_out
        self._edge_weights = weights_out

    def get_edges(self) -> list:
        return self._edge_list

    def get_edge_weights(self) -> list:
        return self._edge_weights

    def get_all_features(self) -> list:
        return self._all_features

    def get_all_targets(self) -> list:
        return self._all_targets
