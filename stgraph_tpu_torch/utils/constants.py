"""Project-wide constants (role-parity: reference ``stgraph/utils/constants.py``).

A copy of ``stgraph_tpu/utils/constants.py``: the port imports nothing of the
JAX package. ``TileConstants`` describes the TPU tiling that the JAX kernels
use; the Hopper kernels choose their own shapes and do not read it.
"""

from enum import Enum

__all__ = ["SizeConstants", "TileConstants"]


class SizeConstants(Enum):
    """Data-size constants (reference ``constants.py:6-18``)."""

    NODE_NORM_SIZE = 2  # norm ndata is (N, 1): 2-D


class TileConstants(Enum):
    """TPU tiling constants used across kernels and layouts."""

    LANES = 128  # vector lanes / MXU edge
    SUBLANES_F32 = 8  # f32/int32 sublane tile
    ROW_BLOCK = 128  # destination rows per SpMM block
    EDGE_CHUNK = 1024  # edges per aligned DMA chunk
