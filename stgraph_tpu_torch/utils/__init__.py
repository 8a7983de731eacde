"""Utilities: normalization, constants, device resolution."""

from stgraph_tpu_torch.utils.constants import SizeConstants, TileConstants
from stgraph_tpu_torch.utils.device import resolve_device
from stgraph_tpu_torch.utils.norm import symmetric_norm

__all__ = ["SizeConstants", "TileConstants", "resolve_device", "symmetric_norm"]
