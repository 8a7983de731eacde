"""Where the port's native libraries are built, and under which name.

Both the host graph builder (``native/``) and the CUDA kernels (``csrc/``)
are compiled at first use into ``build/`` beside the package directory (the
repository root in a checkout; git ignores it). A library's file name
carries a hash of its source (and of the local headers it includes), so
an edited source never loads a stale build, and a finished build is moved
into place atomically, so concurrent processes never load a half-written
file.
"""

from __future__ import annotations

import hashlib
import os

__all__ = ["build_dir", "library_path"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_dir(sub: str) -> str:
    """``<package parent>/build/<sub>``, created if missing."""
    path = os.path.join(os.path.dirname(_PKG_DIR), "build", sub)
    os.makedirs(path, exist_ok=True)
    return path


def library_path(sub: str, name: str, source: str, *headers: str, salt: str = "") -> str:
    """Path of the shared library built from ``source`` and the ``headers``
    it includes (content-hashed, all of them, in order, after ``salt``: the
    build's own flags, where they vary)."""
    digest = hashlib.sha256(salt.encode())
    for path in (source, *headers):
        with open(path, "rb") as fh:
            digest.update(fh.read())
    return os.path.join(build_dir(sub), f"lib{name}-{digest.hexdigest()[:12]}.so")
