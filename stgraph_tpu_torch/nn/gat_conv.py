"""Graph Attention Network layer with a stable segment softmax.

Counterpart of ``stgraph_tpu/nn/gat_conv.py``: the per-head projection and
the ``el``/``er`` scores run dense (``fc`` is an ``nn.Linear`` without
bias), and the attention takes one of the JAX layer's routes
(``gat_conv.py:93-217``):

  * ``dense`` (``impl`` 'auto' or 'dense', N^2 f32 within 64 MB): the
    whole softmax through the dense adjacency (``ops.attention``);
  * ``sparse`` ('auto' or 'sparse' above that): flash-GAT's kernels, K4
    and K8 forward and K9 backward, for the tilings they take
    (``flash_supported``), else the composed route over the graph's blocked
    layouts (K4, K3 and K10 forward; K10 and K3 backward), whose other
    tilings wait for K5 and K1/K2's multi-head modes on CUDA;
  * ``torch`` (or any other compiler ``impl``): the vertex program
    ``softmax_dst(leaky(el_src + er_dst))`` through the port's compiler.

Dropout: ``feat_drop`` and ``attn_drop`` act in training mode, drawing
from the ``generator`` given to ``forward``. Attention dropout runs on the
dense route and on the composed edge-domain route; on the flash route it
needs the kernels' stateless ``edge_keep_mask`` hash, which is not ported,
and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from stgraph_tpu_torch.compiler import STGraph, dsl
from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.utils.device import resolve_device

# Same scale as ops.message._DENSE_BUDGET_BYTES: an (N, N) f32 mask.
_DENSE_ATTN_BUDGET_BYTES = 64 * 1024 * 1024

__all__ = ["GATConv"]


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawing from ``generator``: keep with 1 - rate and
    scale the kept values by 1 / (1 - rate), as flax's ``Dropout``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class GATConv(nn.Module):
    """One multi-head GAT layer: (N, in_feats) -> (N, num_heads, out_feats).

    Args:
      in_feats / out_feats / num_heads: ``fc`` maps in_feats to
        num_heads * out_feats; ``attn_l`` and ``attn_r`` are (H, F).
      feat_drop / attn_drop: dropout rates, applied in training mode.
      negative_slope: the leaky ReLU's slope on the scores.
      activation: optional elementwise activation on the output.
      impl: 'auto' | 'dense' | 'sparse' | 'torch'.
      device: where the parameters live (default ``cuda``).
      generator: the ``torch.Generator`` for the initialisation: xavier
        normal with gain sqrt(2) on all three parameters, the reference's.
    """

    def __init__(
        self,
        in_feats: int,
        out_feats: int,
        num_heads: int,
        feat_drop: float = 0.0,
        attn_drop: float = 0.0,
        negative_slope: float = 0.2,
        activation: Optional[Callable] = None,
        impl: str = "auto",
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.in_feats = in_feats
        self.out_feats = out_feats
        self.num_heads = num_heads
        self.feat_drop = feat_drop
        self.attn_drop = attn_drop
        self.negative_slope = negative_slope
        self.activation = activation
        self.impl = impl
        self.fc = nn.Linear(in_feats, out_feats * num_heads, bias=False, device=dev)
        self.attn_l = nn.Parameter(torch.empty(num_heads, out_feats, device=dev))
        self.attn_r = nn.Parameter(torch.empty(num_heads, out_feats, device=dev))
        gain = math.sqrt(2.0)
        for p in (self.fc.weight, self.attn_l, self.attn_r):
            nn.init.xavier_normal_(p, gain=gain, generator=generator)

    def forward(self, graph, feat: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        from stgraph_tpu_torch.ops import attention as A

        use_attn_drop = self.attn_drop > 0.0 and self.training
        h = _dropout(feat, self.feat_drop, generator) if self.feat_drop > 0.0 and self.training else feat
        feat_src = self.fc(h).reshape(-1, self.num_heads, self.out_feats)
        # Per-head scalar scores (N, H, 1): the halves of the GAT logit.
        el = (feat_src * self.attn_l).sum(-1, keepdim=True)
        er = (feat_src * self.attn_r).sum(-1, keepdim=True)
        csr = graph if isinstance(graph, CSR) else graph.fwd_csr
        n = csr.num_nodes
        slope = self.negative_slope

        if self.impl in ("auto", "dense") and n * n * 4 <= _DENSE_ATTN_BUDGET_BYTES:
            rst = A.dense_gat_attention(
                csr, el, er, feat_src, negative_slope=slope,
                attn_drop_rate=self.attn_drop if use_attn_drop else 0.0, generator=generator,
            )
        elif use_attn_drop and self.impl in ("auto", "sparse") and A.flash_path_available(
            csr, self.num_heads, self.out_feats
        ):
            raise NotImplementedError(
                "attention dropout on the flash route needs K8's and K9's dropout mode "
                "(the stateless edge_keep_mask hash), which is not ported yet "
                "(ROADMAP.md, §2 'K8/K9 dropout mode'); train with attn_drop=0"
            )
        elif use_attn_drop:
            rst = A.composed_gat_attention_dropout(csr, el, er, feat_src, slope, self.attn_drop, generator)
        elif self.impl in ("auto", "sparse"):
            # the composed route reads the graph's blocked layouts, built on first use
            flash = A.flash_path_available(csr, self.num_heads, self.out_feats)
            rst = A.sparse_gat_attention(
                csr, el, er, feat_src, negative_slope=slope,
                blocked=None if flash else getattr(graph, "blocked_fwd", None),
                blocked_t=None if flash else getattr(graph, "blocked_bwd", None),
                csr_t=getattr(graph, "bwd_csr", None),
            )
        else:
            rst = self._vertex_program(graph, el, er, feat_src)
        if self.activation is not None:
            rst = self.activation(rst)
        return rst

    def _vertex_program(self, graph, el, er, feat_src):
        slope = self.negative_slope
        stgraph = STGraph()

        @stgraph.compile(gnn_module=self, impl=self.impl)
        def nb_forward(v):
            # leaky_relu before the stability shift, matching DGL/paper.
            embs = [dsl.leaky_relu(nb.el + v.er, negative_slope=slope) for nb in v.innbs]
            m = dsl.agg_max(embs)
            coeff = [dsl.exp(emb - m) for emb in embs]
            s = dsl.agg_sum(coeff)
            alpha = [c / s for c in coeff]
            feat_srcs = [nb.feat_src for nb in v.innbs]
            return sum([alpha[i] * feat_srcs[i] for i in range(len(feat_srcs))])

        return nb_forward(graph, n_feats={"el": el, "er": er, "feat_src": feat_src})
