"""Timeout-guarded device-to-host fetches.

Counterpart of ``stgraph_tpu/utils/fetch.py``. ``device_fetch`` pulls a
value to the host with a hard timeout by running the blocking copy in a
daemon thread; after the first timeout a process-wide flag short-circuits
later fetches, so a training loop degrades to "metrics n/a" instead of
hanging. The device work is drained first, outside the timeout
(``torch.cuda.synchronize``), so the timeout measures only the copy.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["d2h_available", "device_fetch", "fetch_float"]

_broken = False
_lock = threading.Lock()


def d2h_available() -> bool:
    """False once a fetch has timed out in this process."""
    return not _broken


def _to_numpy(x: Any) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:  # numpy has no bf16; its values are exact in f32
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def device_fetch(x: Any, timeout_s: float = 30.0) -> Optional[np.ndarray]:
    """``x`` as a numpy array, copied with a timeout; None on timeout (and
    on every call after one). A numpy array is returned as it is."""
    global _broken
    if _broken:
        return None
    if isinstance(x, np.ndarray):
        return x
    if torch.is_tensor(x) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    box = {}

    def worker():
        try:
            box["v"] = _to_numpy(x)
        except Exception as exc:  # raised again in the caller's thread
            box["e"] = exc

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        with _lock:
            _broken = True
        return None
    if "e" in box:
        raise box["e"]
    return box.get("v")


def fetch_float(x: Any, timeout_s: float = 30.0) -> float:
    """Scalar fetch; NaN when the device-to-host path is unavailable."""
    v = device_fetch(x, timeout_s)
    return float(v) if v is not None else float("nan")
