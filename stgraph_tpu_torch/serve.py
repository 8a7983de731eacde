"""Serving: inference over a fixed graph with fixed parameters.

Counterpart of ``stgraph_tpu/serve.py``. The JAX ``Predictor`` compiles the
forward pass ahead of time; torch is eager, so ``build`` instead places the
parameters on the device and runs one warm call, which builds the CUDA
kernels the forward reaches and checks the shapes. Every request then runs
under ``torch.inference_mode()``.

Usage::

    predictor = Predictor.build(model, dict(model.state_dict()), (x,))
    logits = predictor(x)

``Predictor.from_checkpoint`` waits for the port of ``utils/checkpoint.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch
from torch import nn

from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["Predictor"]


class Predictor:
    """``apply_fn(params, *inputs)`` over fixed params, on one device."""

    def __init__(self, apply_fn: Callable, params: Dict[str, Any], device: torch.device) -> None:
        self._apply = apply_fn
        self._params = params
        self.device = device

    @classmethod
    def build(
        cls,
        apply_fn,
        params: Dict[str, Any],
        example_inputs: Sequence[Any],
        device=None,
    ) -> "Predictor":
        """Place ``params`` on ``device`` (default ``cuda``) and run one warm
        call on ``example_inputs``.

        ``apply_fn`` is ``fn(params, *inputs)``, or an ``nn.Module``, which
        is then called through ``torch.func.functional_call`` with
        ``params`` as its state.
        """
        dev = resolve_device(device)
        if isinstance(apply_fn, nn.Module):
            module = apply_fn

            def apply_fn(p, *xs):
                return torch.func.functional_call(module, p, xs)

        params = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in params.items()}
        predictor = cls(apply_fn, params, dev)
        predictor(*example_inputs)
        return predictor

    @classmethod
    def from_checkpoint(cls, *args, **kwargs) -> "Predictor":
        raise NotImplementedError(
            "Predictor.from_checkpoint waits for the port of utils/checkpoint.py"
        )

    def __call__(self, *inputs: Any):
        with torch.inference_mode():
            xs = [x.to(self.device) if torch.is_tensor(x) else x for x in inputs]
            return self._apply(self._params, *xs)

    @property
    def cost_analysis(self):
        """The JAX predictor reports XLA's cost estimates; eager torch has
        no compiled executable to ask."""
        return None
