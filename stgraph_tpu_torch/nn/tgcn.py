"""TGCN: GRU-of-GCNs temporal layer.

Counterpart of ``stgraph_tpu/nn/tgcn.py``: three ``GCNConv`` gates (z/r/h)
feeding GRU arithmetic, with the reference's ``clamp(±1e6)`` guards. The
hidden state threads through timesteps; a training loop calls the layer
once per timestep and passes the state on.

The gates' dense layers are ``nn.Linear``s over ``[conv(x), state]``
initialised as flax's ``Dense`` is: lecun-normal weights (a normal with
std ``1/sqrt(fan_in)/0.8796``, truncated at two of its own std) and zero
bias. ``nn.Linear`` stores its weight as (out, in), flax as (in, out);
``convert.tgcn_params_from_jax`` transposes.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from stgraph_tpu_torch.nn.gcn_conv import GCNConv
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["TGCN"]

_CLAMP = 1e6
# std of a unit normal truncated to [-2, 2]: flax's variance_scaling divides
# by it so the truncated draw keeps the intended variance
_TRUNC_STD = 0.87962566103423978


def _lecun_dense(in_features: int, out_features: int, device, generator) -> nn.Linear:
    linear = nn.Linear(in_features, out_features, device=device)
    std = 1.0 / math.sqrt(in_features) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(linear.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
        linear.bias.zero_()
    return linear


class TGCN(nn.Module):
    """``TGCN(in_channels, out_channels)``; call as
    ``layer(graph, x, edge_weight=None, hidden=None) -> new hidden``."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        impl: str = "auto",
        device=None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        dev = resolve_device(device)
        self.in_channels = in_channels
        self.out_channels = out_channels
        for gate in ("z", "r", "h"):
            setattr(self, f"conv_{gate}", GCNConv(in_channels, out_channels, impl=impl,
                                                  device=dev, generator=generator))
            setattr(self, f"linear_{gate}", _lecun_dense(2 * out_channels, out_channels, dev, generator))

    def forward(
        self,
        graph,
        x: torch.Tensor,
        edge_weight: Optional[torch.Tensor] = None,
        hidden: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if hidden is None:
            hidden = x.new_zeros(x.shape[0], self.out_channels)
        z = torch.sigmoid(self._gate(self.conv_z, self.linear_z, graph, x, edge_weight, hidden))
        r = torch.sigmoid(self._gate(self.conv_r, self.linear_r, graph, x, edge_weight, hidden))
        h_tilde = torch.tanh(
            self._gate(self.conv_h, self.linear_h, graph, x, edge_weight, hidden * r)
        )
        return z * hidden + (1.0 - z) * h_tilde

    @staticmethod
    def _gate(conv, linear, graph, x, edge_weight, state) -> torch.Tensor:
        h = conv(graph, x, edge_weight=edge_weight)
        h = torch.clamp(h, -_CLAMP, _CLAMP)
        return linear(torch.cat([h, state], dim=1))
