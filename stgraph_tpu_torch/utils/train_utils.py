"""Training-loop helpers: early stopping, accuracy.

Counterpart of ``stgraph_tpu/utils/train_utils.py``, over ``state_dict``s
of tensors in place of JAX pytrees.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

__all__ = ["EarlyStopping", "accuracy"]


class EarlyStopping:
    """Stop when the monitored score hasn't improved for ``patience`` steps.

    Keeps a copy of the best state in memory (use ``utils.Checkpointer`` for
    durable saves). ``step`` takes a ``state_dict`` or an ``nn.Module``.
    """

    def __init__(self, patience: int = 10, verbose: bool = False) -> None:
        self.patience = patience
        self.verbose = verbose
        self.counter = 0
        self.best_score: Optional[float] = None
        self.best_params: Optional[Dict[str, torch.Tensor]] = None
        self.early_stop = False

    def step(self, score: float, params) -> bool:
        score = float(score)
        if self.best_score is None or score > self.best_score:
            self.best_score = score
            state = params.state_dict() if isinstance(params, torch.nn.Module) else params
            self.best_params = {k: v.detach().clone() for k, v in state.items()}
            self.counter = 0
        else:
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} / {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        return self.early_stop


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> float:
    """Mean top-1 accuracy of (N, C) logits against (N,) integer labels."""
    return float((logits.argmax(-1) == labels).float().mean())
