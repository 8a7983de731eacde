"""Device resolution for the port's entry points.

Every entry point takes ``device=``. Without one it runs on CUDA, and it
raises when CUDA is absent: the port never carries on silently on the CPU.
Callers that want the CPU (the tests) say so with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` when CUDA is asked for (or defaulted to) and
    ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
