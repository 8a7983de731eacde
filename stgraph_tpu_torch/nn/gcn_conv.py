"""Graph Convolutional Network layer (Kipf & Welling) on the vertex frontend.

Counterpart of ``stgraph_tpu/nn/gcn_conv.py``: the dense projection
``h @ W`` runs outside the vertex program, and the aggregation is the traced
one-liner

    ``sum([nb.h * nb.norm for nb in v.innbs]) * v.norm``

which the lowering's SpMM peephole turns into one weighted SpMM (the dense
adjacency on small graphs, the K1 kernel on large ones, with K2 for its
backward).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from stgraph_tpu_torch.compiler import STGraph
from stgraph_tpu_torch.compiler.lowering import GraphView
from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.utils.device import resolve_device
from stgraph_tpu_torch.utils.norm import symmetric_norm

__all__ = ["GCNConv"]


class GCNConv(nn.Module):
    """One GCN layer: ``act(norm·A·norm · (h W) + b)``.

    Args:
      in_feats / out_feats: dense projection shape; ``weight`` is
        (in_feats, out_feats), as in the JAX package, xavier-uniform.
      activation: optional elementwise activation applied after the bias.
      use_bias: add a learned (out_feats,) bias, zero at init.
      impl: aggregation backend — 'auto' | 'torch' | 'dense' | 'kernel'.
      dtype: compute dtype (e.g. ``torch.bfloat16``); params stay f32.
      device: where the parameters live (default ``cuda``).
      generator: the ``torch.Generator`` for the weight init.
    """

    def __init__(
        self,
        in_feats: int,
        out_feats: int,
        activation: Optional[Callable] = None,
        use_bias: bool = True,
        impl: str = "auto",
        dtype: Optional[torch.dtype] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.activation = activation
        self.impl = impl
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_feats, out_feats, device=dev))
        nn.init.xavier_uniform_(self.weight, generator=generator)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(out_feats, device=dev))
        else:
            self.register_parameter("bias", None)

    def forward(self, graph, h: torch.Tensor, edge_weight=None) -> torch.Tensor:
        if not isinstance(graph, (CSR, GraphView)) and not hasattr(graph, "fwd_csr"):
            raise NotImplementedError(
                "GCNConv over the dynamic graph stores (PMA, lazy) comes with "
                "the dynamic-graph slice"
            )
        norm = _get_norm(graph)
        if self.dtype is not None:
            h = h.to(self.dtype)
            norm = norm.to(self.dtype)
        weight = self.weight.to(h.dtype)
        if h.dtype == torch.float32:
            h = h @ weight
        else:  # low-precision inputs: f32 sums, one rounding at the end
            h = (h.float() @ weight.float()).to(h.dtype)

        stgraph = STGraph()
        if edge_weight is None:

            @stgraph.compile(gnn_module=self, impl=self.impl)
            def nb_compute(v):
                return sum([nb.h * nb.norm for nb in v.innbs]) * v.norm

            h = nb_compute(graph, n_feats={"norm": norm, "h": h})
        else:
            edge_weight = torch.as_tensor(edge_weight, device=h.device)
            if edge_weight.dim() == 1:
                edge_weight = edge_weight[:, None]

            @stgraph.compile(gnn_module=self, impl=self.impl)
            def nb_compute(v):
                return (
                    sum(
                        [
                            nb_edge.src.norm * nb_edge.src.h * nb_edge.edge_weight
                            for nb_edge in v.inedges
                        ]
                    )
                    * v.norm
                )

            h = nb_compute(
                graph,
                n_feats={"norm": norm, "h": h},
                e_feats={"edge_weight": edge_weight},
            )

        if self.bias is not None:
            h = h + self.bias.to(h.dtype)
        if self.activation is not None:
            h = self.activation(h)
        return h


def _get_norm(graph) -> torch.Tensor:
    """The (N, 1) symmetric-normalization vector: the graph's ``norm``
    ndata when set, else ``deg^{-1/2}`` computed (and cached) from the CSR."""
    norm = graph.get_ndata("norm") if hasattr(graph, "get_ndata") else None
    if norm is None:
        norm = symmetric_norm(graph.csr if isinstance(graph, GraphView) else graph)
    elif not torch.is_tensor(norm):
        csr = graph.fwd_csr
        norm = torch.as_tensor(np.asarray(norm), device=csr.device)
    if norm.dim() != 2 or norm.shape[1] != 1:
        raise ValueError("node data 'norm' must have shape (num_nodes, 1)")
    return norm
