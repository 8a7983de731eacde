"""Utilities: normalization, constants, device resolution, checkpoints,
training helpers and the drivers' metrics table."""

from stgraph_tpu_torch.utils.checkpoint import Checkpointer
from stgraph_tpu_torch.utils.constants import SizeConstants, TileConstants
from stgraph_tpu_torch.utils.data_table import DataTable
from stgraph_tpu_torch.utils.device import resolve_device
from stgraph_tpu_torch.utils.norm import symmetric_norm
from stgraph_tpu_torch.utils.train_utils import EarlyStopping, accuracy

__all__ = [
    "Checkpointer",
    "DataTable",
    "EarlyStopping",
    "SizeConstants",
    "TileConstants",
    "accuracy",
    "resolve_device",
    "symmetric_norm",
]
