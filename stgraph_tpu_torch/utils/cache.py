"""A persistent cache of the port's built libraries.

Counterpart of ``stgraph_tpu/utils/cache.py``, which points XLA's
persistent compilation cache at a directory. The port compiles no XLA
program; what it builds once and keeps are its kernel and native
libraries (``utils/build.py``, content-hashed by their sources). One call
near process start points them at a directory shared between checkouts,
so a rerun loads what an earlier one built instead of running nvcc again.
"""

from __future__ import annotations

import os
from typing import Optional

from stgraph_tpu_torch.utils import build

__all__ = ["setup_compilation_cache"]


def setup_compilation_cache(path: Optional[str] = None) -> None:
    """Build and load the libraries under ``path``, or under
    ``$STGRAPH_TPU_CACHE_DIR`` when ``path`` is not given and that is set.

    With neither, the libraries stay in ``build/`` beside the package.
    Idempotent; takes effect only when called. Raises ``OSError`` when the
    directory cannot be made (JAX's version swallows the error).
    """
    path = path or os.environ.get("STGRAPH_TPU_CACHE_DIR")
    if not path:
        return
    os.makedirs(path, exist_ok=True)
    build.set_build_root(path)
