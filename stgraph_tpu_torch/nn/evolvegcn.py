"""EvolveGCN: a GCN whose weights evolve over time through a recurrent cell.

Counterpart of ``stgraph_tpu/nn/evolvegcn.py`` (Pareja et al., AAAI'20):

  * **-O variant**: the GCN weight matrix itself is the recurrent state,
    updated each timestep by a GRU cell that takes the previous weights as
    both input and hidden state;
  * **-H variant**: the weights are the hidden state of a GRU whose input
    is a top-k summary of the current node embeddings.

Both are called as ``layer(graph, x, weight=None) -> (out, new_weight)``; a
training loop threads the evolving weights through its timesteps (the
weight of step 0 is the ``weight`` parameter), as it threads TGCN's hidden
state. The aggregation is ``GCNConv``'s vertex program
``sum([nb.h * nb.norm for nb in v.innbs]) * v.norm``, which the lowering's
SpMM peephole turns into one weighted SpMM: the dense adjacency on small
graphs, K1 forward and K2 backward on the ``kernel`` route (the weights
are ``norm[src]``).

The GRU's six dense maps are ``nn.Linear``s over the last axis of the
(in, out) matrix, initialised as flax's ``Dense`` is (lecun-normal, zero
bias); ``convert.evolvegcn_params_from_jax`` transposes flax's (in, out)
kernels into them. The H variant picks its top rows by a stable
descending sort, so ties go to the lower index, as ``lax.top_k`` breaks
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from stgraph_tpu_torch.compiler import STGraph
from stgraph_tpu_torch.nn.gcn_conv import _get_norm
from stgraph_tpu_torch.nn.tgcn import _lecun_dense
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["EvolveGCNH", "EvolveGCNO"]


class _WeightGRU(nn.Module):
    """GRU cell over a (in, out) weight matrix, column-wise gates."""

    def __init__(self, out_feats: int, device, generator) -> None:
        super().__init__()
        for gate in ("z", "r", "h"):
            setattr(self, f"w{gate}_x", _lecun_dense(out_feats, out_feats, device, generator))
            setattr(self, f"w{gate}_h", _lecun_dense(out_feats, out_feats, device, generator, bias=False))

    def forward(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        z = torch.sigmoid(self.wz_x(x) + self.wz_h(h))
        r = torch.sigmoid(self.wr_x(x) + self.wr_h(h))
        htil = torch.tanh(self.wh_x(x) + self.wh_h(r * h))
        return z * h + (1 - z) * htil


def _gcn_aggregate(graph, h: torch.Tensor, impl: str) -> torch.Tensor:
    norm = _get_norm(graph)
    stgraph = STGraph()

    @stgraph.compile(impl=impl)
    def nb_compute(v):
        return sum([nb.h * nb.norm for nb in v.innbs]) * v.norm

    return nb_compute(graph, n_feats={"norm": norm, "h": h})


def _top_rows(y: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of ``y``'s ``k`` largest values, largest first, ties to
    the lower index (a stable descending sort: ``lax.top_k``'s order)."""
    return torch.sort(y, descending=True, stable=True).indices[:k]


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` summed in f32, cast to x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


class _EvolveGCN(nn.Module):
    def __init__(self, in_feats: int, out_feats: int, impl: str = "auto", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.in_feats, self.out_feats, self.impl = in_feats, out_feats, impl
        self.weight = nn.Parameter(torch.empty(in_feats, out_feats, device=dev))
        nn.init.xavier_uniform_(self.weight, generator=generator)
        self.gru = _WeightGRU(out_feats, dev, generator)


class EvolveGCNO(_EvolveGCN):
    """EvolveGCN-O: ``W_t = GRU(W_{t-1}, W_{t-1})``, then a GCN conv.

    Args:
      in_feats / out_feats: the evolving weight's shape (in_feats, out_feats),
        xavier-uniform at init, as in the JAX package.
      impl: aggregation backend — 'auto' | 'torch' | 'dense' | 'kernel'
        (JAX's 'pallas').
      device: where the parameters live (default ``cuda``).
      generator: the ``torch.Generator`` for the init.
    """

    def forward(self, graph, x: torch.Tensor, weight: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.weight.to(x.dtype) if weight is None else weight
        w = self.gru(w, w)
        return _gcn_aggregate(graph, _project(x, w), self.impl), w


class EvolveGCNH(_EvolveGCN):
    """EvolveGCN-H: the weights are GRU state driven by top-k node summaries.

    Takes ``EvolveGCNO``'s arguments and adds ``summarize_p`` (in_feats,),
    drawn from a normal of std ``1/sqrt(in_feats)``. A graph with fewer
    than ``out_feats`` nodes is refused, as ``lax.top_k`` refuses it.
    """

    def __init__(self, in_feats: int, out_feats: int, impl: str = "auto", device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__(in_feats, out_feats, impl, device, generator)
        self.summarize_p = nn.Parameter(torch.empty(in_feats, device=self.weight.device))
        nn.init.normal_(self.summarize_p, 0.0, 1.0 / in_feats**0.5, generator=generator)

    def forward(self, graph, x: torch.Tensor, weight: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if x.shape[0] < self.out_feats:
            raise ValueError(f"EvolveGCN-H summarizes {self.out_feats} rows, but x has only {x.shape[0]}")
        w = self.weight.to(x.dtype) if weight is None else weight
        p = self.summarize_p.to(x.dtype)
        # scores y = X p / |p|; the out_feats highest-scoring rows
        y = x @ p / (torch.linalg.vector_norm(p) + 1e-12)
        idx = _top_rows(y.detach(), self.out_feats)
        summary = x[idx] * torch.tanh(y[idx])[:, None]  # (out_feats, in_feats)
        w = self.gru(summary.T, w)
        return _gcn_aggregate(graph, _project(x, w), self.impl), w
