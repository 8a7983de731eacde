"""Checkpoint/resume for training state.

Counterpart of ``stgraph_tpu/utils/checkpoint.py``: a step-indexed
directory (``step_%010d``) with keep-last-k retention. The JAX package
writes pytrees with orbax (or an npz fallback); the port writes a tree of
tensors (``state_dict``s of a model and an optimizer, plain numbers) with
``torch.save`` and reads it back with ``torch.load(weights_only=True)``.

Usage::

    ckpt = Checkpointer("/tmp/run1")
    ckpt.save(step, {"model": model.state_dict(), "optimizer": opt.state_dict()})
    state = ckpt.restore()           # latest, or None if empty
    state = ckpt.restore(step=120)   # a given step
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Mapping, Optional

import torch

__all__ = ["Checkpointer"]

_STATE_FILE = "state.pt"


def _like(tree: Any, like: Any, path: str = "state") -> Any:
    """``tree`` with each tensor moved to the device of the tensor at the
    same place in ``like``; raises ``ValueError`` where the structures
    differ."""
    if torch.is_tensor(like):
        if not torch.is_tensor(tree) or tree.shape != like.shape:
            raise ValueError(f"{path}: checkpoint holds {tree!r:.80}, expected a tensor of shape {tuple(like.shape)}")
        return tree.to(like.device)
    if isinstance(like, Mapping):
        if not isinstance(tree, Mapping) or set(tree) != set(like):
            raise ValueError(f"{path}: checkpoint keys differ from the expected ones")
        return {k: _like(tree[k], like[k], f"{path}[{k!r}]") for k in like}
    if isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{path}: checkpoint holds another sequence")
        return type(like)(_like(t, l, f"{path}[{i}]") for i, (t, l) in enumerate(zip(tree, like)))
    return tree


class Checkpointer:
    """Step-indexed checkpoint directory with keep-last-k retention."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self._dir = os.path.abspath(directory)
        self._keep = keep
        os.makedirs(self._dir, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step:010d}")

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self._dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self._dir, name, _STATE_FILE)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> str:
        """Write ``state`` as step ``step`` (atomically: a reader never sees
        a half-written file) and drop all but the last ``keep`` steps."""
        path = self._step_dir(step)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, f"{_STATE_FILE}.{os.getpid()}.tmp")
        torch.save(state, tmp)
        os.replace(tmp, os.path.join(path, _STATE_FILE))
        self._gc()
        return path

    def restore(self, step: Optional[int] = None, like: Any = None) -> Optional[Any]:
        """Restore ``step`` (default: the latest; None when there is none).

        Tensors load onto the CPU; ``like``, a state of the same structure,
        places each on the device of its counterpart there and checks that
        keys and shapes agree.
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                return None
        state = torch.load(
            os.path.join(self._step_dir(step), _STATE_FILE), map_location="cpu", weights_only=True
        )
        return state if like is None else _like(state, like)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self._keep] if self._keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
