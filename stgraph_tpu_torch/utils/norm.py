"""Degree-normalization helpers for GCN-style layers.

Counterpart of ``stgraph_tpu/utils/norm.py``: ``norm = in_deg^{-1/2}``, the
value every reference training script passes as ndata.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["symmetric_norm"]


def symmetric_norm(graph) -> torch.Tensor:
    """(N, 1) float32 ``in_degree^{-1/2}`` with zero-degree nodes mapped to 1.

    Computed on the host from the CSR's ``indptr`` mirror and placed on the
    graph's device; the result is cached on the CSR, so layers that call
    this every forward pay one upload per graph.
    """
    csr = graph.fwd_csr if hasattr(graph, "fwd_csr") else graph

    def make():
        indptr = csr.host_arrays()[0]
        deg = np.diff(indptr).astype(np.float32)
        norm = np.where(deg > 0, 1.0 / np.sqrt(np.maximum(deg, 1.0)), 1.0)
        return torch.from_numpy(norm[:, None].astype(np.float32)).to(csr.device)

    return csr.cached("symmetric_norm", make)
