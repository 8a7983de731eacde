"""Carry parameters from the JAX package to the port.

``gcn_params_from_jax`` turns a flax parameter tree, given as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), into a ``state_dict``:

  * a single ``GCNConv``: ``{"params": {"weight", "bias"}}`` →
    ``{"weight", "bias"}``, loadable into ``stgraph_tpu_torch.nn.GCNConv``;
  * a stack built in a compact flax module (``GCNConv_0 .. GCNConv_k``, as
    ``benchmarking/gcn/train.py`` builds it) → ``{"layers.0.weight",
    "layers.0.bias", ...}``, loadable into a module that holds its
    ``GCNConv``s in an ``nn.ModuleList`` named ``layers``.

Both packages store the GCN weight as (in_feats, out_feats), so no
transpose is needed there.

``tgcn_params_from_jax`` does the same for a flax ``TGCN`` tree
(``conv_z/r/h`` {``weight``, ``bias``} and ``linear_z/r/h`` {``kernel``,
``bias``}), loadable into ``stgraph_tpu_torch.nn.TGCN``. A flax ``Dense``
kernel is (in, out) and an ``nn.Linear`` weight (out, in): it is
transposed.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["gcn_params_from_jax", "tgcn_params_from_jax"]

_LAYER = re.compile(r"^GCNConv_(\d+)$")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _layer(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}weight": _tensor(tree["weight"])}
    if "bias" in tree:
        out[f"{prefix}bias"] = _tensor(tree["bias"])
    return out


def gcn_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax GCN parameter tree (numpy leaves) as a torch ``state_dict``."""
    tree = params.get("params", params)
    if "weight" in tree:
        return _layer(tree, "")
    layers = {}
    for name, sub in tree.items():
        m = _LAYER.match(name)
        if m is None:
            raise ValueError(f"not a GCNConv parameter tree: unexpected key {name!r}")
        layers[int(m.group(1))] = sub
    if sorted(layers) != list(range(len(layers))):
        raise ValueError(f"GCNConv layers are not numbered 0..k: {sorted(layers)}")
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(layers)):
        out.update(_layer(layers[i], f"layers.{i}."))
    return out


def tgcn_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``TGCN`` parameter tree (numpy leaves) as a torch ``state_dict``."""
    tree = params.get("params", params)
    expected = {f"{kind}_{gate}" for kind in ("conv", "linear") for gate in "zrh"}
    if set(tree) != expected:
        raise ValueError(f"not a TGCN parameter tree: keys {sorted(tree)}")
    out: Dict[str, torch.Tensor] = {}
    for gate in "zrh":
        out.update(_layer(tree[f"conv_{gate}"], f"conv_{gate}."))
        dense = tree[f"linear_{gate}"]
        out[f"linear_{gate}.weight"] = _tensor(dense["kernel"]).T.contiguous()
        out[f"linear_{gate}.bias"] = _tensor(dense["bias"])
    return out
