"""Utilities: normalization, constants, device resolution and discovery,
checkpoints, training helpers, the drivers' metrics table, timeout-guarded
fetches, profiling and the built libraries' cache (``utils.cache``)."""

from stgraph_tpu_torch.utils.checkpoint import Checkpointer
from stgraph_tpu_torch.utils.constants import SizeConstants, TileConstants
from stgraph_tpu_torch.utils.data_table import DataTable
from stgraph_tpu_torch.utils.device import resolve_device
from stgraph_tpu_torch.utils.device_info import DeviceInfo
from stgraph_tpu_torch.utils.fetch import d2h_available, device_fetch, fetch_float
from stgraph_tpu_torch.utils.norm import symmetric_norm
from stgraph_tpu_torch.utils.train_utils import EarlyStopping, accuracy
from stgraph_tpu_torch.utils import profiler

__all__ = [
    "Checkpointer",
    "DataTable",
    "DeviceInfo",
    "EarlyStopping",
    "SizeConstants",
    "TileConstants",
    "accuracy",
    "d2h_available",
    "device_fetch",
    "fetch_float",
    "profiler",
    "resolve_device",
    "symmetric_norm",
]
