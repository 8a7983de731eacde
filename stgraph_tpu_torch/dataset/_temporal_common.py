"""Shared helpers for the temporal dataset loaders.

A copy of ``stgraph_tpu/dataset/_temporal_common.py`` (host numpy): edge
weights sorted by (dst, src), the CSR eid order; per-node z-score
standardisation of targets; the synthetic ring-plus-random topology and the
AR(1) node series of the synthetic fallbacks, with the same random calls in
the same order as the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["ar1_series", "ring_plus_random_edges", "sort_weights_dst_src", "zscore"]


def sort_weights_dst_src(edges: Sequence, weights: Sequence) -> np.ndarray:
    """Edge weights reordered by (dst, src) — the reference's presort
    (e.g. ``wikimath_dataloader.py:155-163``)."""
    comb = sorted(
        ((e[0], e[1], w) for e, w in zip(edges, weights)),
        key=lambda x: (x[1], x[0]),
    )
    return np.array([c[2] for c in comb])


def zscore(stacked: np.ndarray) -> np.ndarray:
    """Per-node standardization with the reference's epsilon
    (``wikimath_dataloader.py:172-175``)."""
    return (stacked - np.mean(stacked, axis=0)) / (np.std(stacked, axis=0) + 1e-10)


def ring_plus_random_edges(
    rng: np.random.Generator, num_nodes: int, num_edges: int
) -> List[List[int]]:
    """Deterministic synthetic topology: ring for connectivity + random.

    Allows self-loops when the request exceeds the simple-graph maximum
    (PedalMe's 225 edges on 15 nodes is the full n² including loops).
    """
    if num_edges > num_nodes * num_nodes:
        raise ValueError(f"cannot fit {num_edges} edges on {num_nodes} nodes")
    allow_loops = num_edges > num_nodes * (num_nodes - 1)
    edges = {(int(i), int((i + 1) % num_nodes)) for i in range(num_nodes)}
    if allow_loops and num_edges == num_nodes * num_nodes:
        edges = {(i, j) for i in range(num_nodes) for j in range(num_nodes)}
    while len(edges) < num_edges:
        s, d = int(rng.integers(0, num_nodes)), int(rng.integers(0, num_nodes))
        if s != d or allow_loops:
            edges.add((s, d))
    return [list(e) for e in sorted(edges)][:num_edges]


def ar1_series(
    rng: np.random.Generator, timestamps: int, num_nodes: int, rho: float = 0.8
) -> np.ndarray:
    """(T, N) smooth AR(1) node time series — synthetic regression targets
    with real temporal structure so TGCN benchmarks stay meaningful."""
    x = np.zeros((timestamps, num_nodes), np.float64)
    x[0] = rng.standard_normal(num_nodes)
    drive = rng.standard_normal((timestamps, num_nodes))
    season = np.sin(np.arange(timestamps)[:, None] * (2 * np.pi / 24.0))
    for t in range(1, timestamps):
        x[t] = rho * x[t - 1] + 0.2 * drive[t] + 0.3 * season[t]
    return x
