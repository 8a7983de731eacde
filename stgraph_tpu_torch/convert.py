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

``gat_params_from_jax`` does the same for a flax ``GATConv`` tree (``fc``
{``kernel``}, ``attn_l``, ``attn_r``), or a compact stack of them
(``GATConv_0 .. GATConv_k`` → ``layers.i.*``), loadable into
``stgraph_tpu_torch.nn.GATConv``: ``fc.kernel`` (in, H*F) becomes the
``nn.Linear`` weight ``fc.weight`` (H*F, in); the (H, F) attention
vectors carry over as they are.

``tgcn_params_from_jax`` does the same for a flax ``TGCN`` tree
(``conv_z/r/h`` {``weight``, ``bias``} and ``linear_z/r/h`` {``kernel``,
``bias``}), loadable into ``stgraph_tpu_torch.nn.TGCN``. A flax ``Dense``
kernel is (in, out) and an ``nn.Linear`` weight (out, in): it is
transposed.

``lazy_pair_from_jax`` carries a JAX ``LazyPair`` (its two ``LazyStore``s,
leaves as numpy: ``jax.tree_util.tree_map(np.asarray, pair)``) into the
port's ``LazyPair`` on ``device``, so that both packages start from the same
dynamic-graph state.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from stgraph_tpu_torch.graph.delta_graph import pack_keys
from stgraph_tpu_torch.graph.lazy_store import LazyStore
from stgraph_tpu_torch.ops.dyn_spmm import LazyPair
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["gat_params_from_jax", "gcn_params_from_jax", "lazy_pair_from_jax", "tgcn_params_from_jax"]

_LAYER = re.compile(r"^GCNConv_(\d+)$")
_GAT_LAYER = re.compile(r"^GATConv_(\d+)$")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _layer(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    out = {f"{prefix}weight": _tensor(tree["weight"])}
    if "bias" in tree:
        out[f"{prefix}bias"] = _tensor(tree["bias"])
    return out


def _stack(tree: Mapping[str, Any], pattern, kind: str, layer_fn) -> Dict[str, torch.Tensor]:
    """A compact flax stack ``<kind>_0 .. <kind>_k`` as ``layers.i.*``."""
    layers = {}
    for name, sub in tree.items():
        m = pattern.match(name)
        if m is None:
            raise ValueError(f"not a {kind} parameter tree: unexpected key {name!r}")
        layers[int(m.group(1))] = sub
    if sorted(layers) != list(range(len(layers))):
        raise ValueError(f"{kind} layers are not numbered 0..k: {sorted(layers)}")
    out: Dict[str, torch.Tensor] = {}
    for i in range(len(layers)):
        out.update(layer_fn(layers[i], f"layers.{i}."))
    return out


def gcn_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax GCN parameter tree (numpy leaves) as a torch ``state_dict``."""
    tree = params.get("params", params)
    if "weight" in tree:
        return _layer(tree, "")
    return _stack(tree, _LAYER, "GCNConv", _layer)


def _gat_layer(tree: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {
        f"{prefix}fc.weight": _tensor(tree["fc"]["kernel"]).T.contiguous(),
        f"{prefix}attn_l": _tensor(tree["attn_l"]),
        f"{prefix}attn_r": _tensor(tree["attn_r"]),
    }


def gat_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax GAT parameter tree (numpy leaves) as a torch ``state_dict``."""
    tree = params.get("params", params)
    if "fc" in tree:
        return _gat_layer(tree, "")
    return _stack(tree, _GAT_LAYER, "GATConv", _gat_layer)


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


def _lazy_store_from_jax(store, device):
    def t(name, dtype):
        return torch.from_numpy(np.array(getattr(store, name), dtype)).to(device)

    n = int(store.num_nodes)
    rows, cols = t("rows", np.int32), t("cols", np.int32)
    return LazyStore(
        rows=rows, cols=cols, w=t("w", np.float32), keys=pack_keys(rows, cols, n),
        tail_rows=t("tail_rows", np.int32), tail_cols=t("tail_cols", np.int32),
        tail_w=t("tail_w", np.float32), tail_count=int(store.tail_count),
        anti_rows=t("anti_rows", np.int32), anti_cols=t("anti_cols", np.int32),
        anti_count=int(store.anti_count),
        num_edges=torch.tensor(int(store.num_edges), dtype=torch.int64, device=device),
        num_nodes=n, weighted=bool(store.weighted),
    )


def lazy_pair_from_jax(pair, device=None):
    """A JAX ``LazyPair`` (numpy leaves) as the port's ``LazyPair`` on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return LazyPair(fwd=_lazy_store_from_jax(pair.fwd, dev), bwd=_lazy_store_from_jax(pair.bwd, dev))
