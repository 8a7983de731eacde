"""Graph Attention Network layer with a stable segment softmax.

Counterpart of ``stgraph_tpu/nn/gat_conv.py``: the per-head projection and
the ``el``/``er`` scores run dense (``fc`` is an ``nn.Linear`` without
bias), and the attention takes one of the JAX layer's routes
(``gat_conv.py:93-217``):

  * ``dense`` (``impl`` 'auto' or 'dense', N^2 f32 within 64 MB): the
    whole softmax through the dense adjacency (``ops.attention``);
  * ``sparse`` ('auto' or 'sparse' above that): flash-GAT's kernels, K4
    and K8 forward and K9 backward, for the tilings they take
    (``flash_supported``); else the composed route: its rowmask branch (K1's
    and K2's heads modes) where the row-wise kernel takes the tiling, or the
    blocked kernel K10 over the graph's blocked layouts, with K4/K3 (K5 and
    K1's no-gather mode past 16 heads) for the segment reductions;
  * ``torch`` (or any other compiler ``impl``): the vertex program
    ``softmax_dst(leaky(el_src + er_dst))`` through the port's compiler.

Dropout: ``feat_drop`` and ``attn_drop`` act in training mode, drawing
from the ``generator`` given to ``forward`` (the default generator of the
data's device when None), in this order: ``feat_drop``'s ``torch.rand``
over the input, then attention dropout's draw (one seed, or a
``torch.rand`` over the (capacity, H) coefficients). Attention dropout
takes the JAX layer's routes on its TPU (``gat_conv.py:117-173``), by the
tiling alone, on the CPU as on the card:

  * the dense route where it applies, with ``torch.rand`` per
    (dst, src, head);
  * (a) at the reference's flash tilings (``flash_gat.reference_flash_tiling``)
    that the port's flash kernels take (``flash_supported``): the flash
    route with K8's and K9's dropout mode (their plain versions on the
    CPU), on one uint32 seed drawn per call as a one-element tensor on the
    generator's device, so no host sync (``attention_dropout_seed``); the
    keep mask is ``edge_keep_mask``'s hash, the JAX kernels' bit for bit;
  * (b) at the reference's flash tilings past the port's (such as 4 x 128,
    8 x 64, 16 x 32, 1 x 384): the edge-domain route
    (``composed_gat_attention_dropout``, plain torch) with the same hash
    mask over the CSR, ``edge_keep_mask(cols, rows, seed, H, p)``;
  * (c) every other tiling or ``impl``: the edge-domain route
    with ``torch.rand`` from the generator, as the reference's
    ``jax.random.bernoulli`` route.

Evaluation mode draws nothing and takes the routes without dropout.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from stgraph_tpu_torch.compiler import STGraph, dsl
from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops.flash_gat import edge_keep_mask, flash_supported, reference_flash_tiling
from stgraph_tpu_torch.utils.device import resolve_device

# Same scale as ops.message._DENSE_BUDGET_BYTES: an (N, N) f32 mask.
_DENSE_ATTN_BUDGET_BYTES = 64 * 1024 * 1024

__all__ = ["GATConv", "attention_dropout_seed"]


def attention_dropout_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """The seed of one layer call's hashed attention-dropout mask: a uint32
    in a one-element int64 tensor, drawn from ``generator`` on its device
    (from ``device``'s default generator when None), so that nothing waits
    for the card. The JAX layer draws ``jax.random.bits(attn_rng, uint32)``."""
    dev = generator.device if generator is not None else device
    return torch.randint(0, 1 << 32, (1,), generator=generator, device=dev, dtype=torch.int64)


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
        heads, f = self.num_heads, self.out_feats

        if self.impl in ("auto", "dense") and n * n * 4 <= _DENSE_ATTN_BUDGET_BYTES:
            rst = A.dense_gat_attention(
                csr, el, er, feat_src, negative_slope=slope,
                attn_drop_rate=self.attn_drop if use_attn_drop else 0.0, generator=generator,
            )
        elif use_attn_drop and self.impl in ("auto", "sparse") and reference_flash_tiling(heads, f):
            seed = attention_dropout_seed(generator, feat.device)
            if flash_supported(heads, f):  # (a): K8's and K9's dropout mode
                rst = A.sparse_gat_attention(
                    csr, el, er, feat_src, negative_slope=slope, csr_t=getattr(graph, "bwd_csr", None),
                    attn_drop_rate=self.attn_drop, attn_drop_seed=seed,
                )
            else:  # (b): the same hash mask on the edge-domain route
                keep = edge_keep_mask(csr.cols, csr.rows, seed, heads, self.attn_drop)
                rst = A.composed_gat_attention_dropout(csr, el, er, feat_src, slope, self.attn_drop, keep=keep)
        elif use_attn_drop:  # (c)
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
