"""Dataset base classes: download → cache → process, with synthetic fallback.

A copy of ``stgraph_tpu/dataset/base.py`` (host numpy only; the port
imports nothing of the JAX package): the cache → download → synthetic flow,
the ``STGRAPH_TPU_DATASET_MIRROR`` variable and ``synthetic_graph`` are
verbatim, so one seed gives both packages the same data. One difference:
the cache lives in ``~/.stgraph/dataset_cache_torch/<name>.json`` (or in a
loader's ``cache_dir``), so neither package reads the other's files.
A failed download marks the process offline (``STGraphDataset._offline``)
and every loader then synthesizes its data; a caller that knows it has no
network sets that flag first and skips the attempt.
"""

from __future__ import annotations

import json
import os
import urllib.request
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

import numpy as np

__all__ = [
    "STGraphDataset",
    "STGraphStaticDataset",
    "STGraphTemporalDataset",
    "STGraphDynamicDataset",
]


class STGraphDataset(ABC):
    """download/cache/process lifecycle shared by all loaders."""

    def __init__(self) -> None:
        self.name = ""
        self.gdata: Dict[str, Any] = {}
        self.synthetic = False
        self._dataset: Dict[str, Any] = {}
        self._url = ""
        self._verbose = False
        self._cache_folder = "dataset_cache_torch"
        self._cache_root: Optional[str] = None  # a loader's cache_dir
        self._download_timeout = 10.0

    # -- cache ------------------------------------------------------------
    def _cache_dir(self) -> str:
        d = self._cache_root or os.path.join(
            os.path.expanduser("~"), ".stgraph", self._cache_folder
        )
        os.makedirs(d, exist_ok=True)
        return d

    def _get_cache_file_path(self) -> str:
        return os.path.join(self._cache_dir(), f"{self.name}.json")

    def _has_dataset_cache(self) -> bool:
        return os.path.exists(self._get_cache_file_path())

    def _delete_cached_dataset(self) -> None:
        if self._has_dataset_cache():
            os.remove(self._get_cache_file_path())

    def _save_dataset(self) -> None:
        with open(self._get_cache_file_path(), "w") as f:
            json.dump(self._dataset, f)

    def _load_dataset(self) -> None:
        with open(self._get_cache_file_path()) as f:
            self._dataset = json.load(f)

    # -- acquisition -------------------------------------------------------
    _offline: bool = False  # process-wide: set after the first failed fetch

    def _download_dataset(self) -> bool:
        if STGraphDataset._offline:
            return False

        # Mirror support (air-gapped deployments and the offline URL-path
        # tests): STGRAPH_TPU_DATASET_MIRROR=<base-url> fetches
        # <base-url>/<original filename> instead of the upstream host.
        url = self._url
        mirror = os.environ.get("STGRAPH_TPU_DATASET_MIRROR")
        if mirror:
            url = mirror.rstrip("/") + "/" + url.rsplit("/", 1)[-1]

        def fetch():
            with urllib.request.urlopen(
                url, timeout=self._download_timeout
            ) as resp:
                return json.loads(resp.read().decode("utf-8"))

        # urlopen's timeout does not cover DNS resolution, which blocks for
        # minutes in air-gapped environments — enforce a hard wall via a
        # *daemon* thread (an executor's non-daemon worker would also stall
        # interpreter exit while stuck in getaddrinfo).
        import threading

        box: dict = {}

        def worker():
            try:
                box["value"] = fetch()
            except Exception as exc:  # zero-egress environments land here
                box["error"] = exc

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        t.join(self._download_timeout)
        if "value" in box:
            self._dataset = box["value"]
            return True
        STGraphDataset._offline = True
        if self._verbose:
            reason = box.get("error", "timed out")
            print(f"[{self.name}] download failed ({reason}); using synthetic data")
        return False

    def _acquire(self, redownload: bool = False) -> None:
        """Run the reference's cache-or-download flow, ending in either the
        real dataset or the loader's synthetic equivalent."""
        if redownload:
            self._delete_cached_dataset()
        if self._has_dataset_cache():
            self._load_dataset()
            # Cached synthetic data must still report as synthetic —
            # provenance travels with the cache file (older caches without
            # the marker are treated as real downloads).
            self.synthetic = bool(self._dataset.pop("_synthetic", False))
            return
        if self._download_dataset():
            self._save_dataset()
            return
        self._dataset = self._generate_synthetic()
        self.synthetic = True
        # Cache the (deterministic) synthetic data too: regeneration is
        # slower than a JSON load, and it keeps the cache flow uniform.
        # The marker keeps provenance honest across cache reloads.
        self._dataset["_synthetic"] = True
        self._save_dataset()
        self._dataset.pop("_synthetic", None)

    @abstractmethod
    def _generate_synthetic(self) -> Dict[str, Any]:
        """Produce a dataset dict with the real dataset's schema and sizes."""

    @abstractmethod
    def _process_dataset(self) -> None: ...


class STGraphStaticDataset(STGraphDataset):
    def __init__(self) -> None:
        super().__init__()
        self.gdata = {"num_nodes": 0, "num_edges": 0, "num_feats": 0}


class STGraphTemporalDataset(STGraphDataset):
    def __init__(self) -> None:
        super().__init__()
        self.gdata = {"num_nodes": 0, "num_edges": 0, "total_timestamps": 0}
        self._lags = 8
        self._cutoff_time: Optional[int] = None

    def _total_from(self, available: int) -> int:
        if self._cutoff_time is not None:
            return min(available, self._cutoff_time)
        return available


class STGraphDynamicDataset(STGraphDataset):
    def __init__(self) -> None:
        super().__init__()
        self.gdata = {"num_nodes": {}, "num_edges": {}, "total_timestamps": 0}
        self._lags = 8
        self._cutoff_time: Optional[int] = None

    def _total_from(self, available: int) -> int:
        if self._cutoff_time is not None:
            return min(available, self._cutoff_time)
        return available


def synthetic_graph(
    rng: np.random.Generator, num_nodes: int, num_edges: int
) -> list:
    """Random simple directed edge list with a planted ring for connectivity."""
    edges = {(int(i), int((i + 1) % num_nodes)) for i in range(num_nodes)}
    while len(edges) < num_edges:
        s = int(rng.integers(0, num_nodes))
        d = int(rng.integers(0, num_nodes))
        if s != d:
            edges.add((s, d))
    out = sorted(edges)
    return [list(e) for e in out[:num_edges]]
