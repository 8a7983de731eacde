"""Device discovery and a table of the visible devices.

Counterpart of ``stgraph_tpu/utils/device_info.py`` (the reference's
``DeviceInfo``): for logs and bug reports, the CUDA devices with their
name, the process's rank and their memory.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["DeviceInfo"]

_COLUMNS = ["id", "platform", "kind", "process", "hbm_limit_gb", "hbm_in_use_mb"]


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class DeviceInfo:
    """Snapshot of the visible CUDA devices; raises without CUDA unless
    ``device="cpu"``, which lists the CPU as one device."""

    def __init__(self, device=None) -> None:
        dev = resolve_device(device)
        self.backend = dev.type
        self.devices = ([torch.device("cpu")] if dev.type == "cpu"
                        else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])

    def rows(self) -> List[Dict[str, str]]:
        out = []
        for d in self.devices:
            if d.type == "cuda":
                kind = torch.cuda.get_device_name(d)
                limit = torch.cuda.get_device_properties(d).total_memory
                in_use = torch.cuda.memory_allocated(d)
            else:
                kind, limit, in_use = "cpu", 0, 0
            out.append({
                "id": str(d.index or 0),
                "platform": "gpu" if d.type == "cuda" else "cpu",
                "kind": kind,
                "process": str(_rank()),
                "hbm_limit_gb": f"{limit / 1e9:.1f}",
                "hbm_in_use_mb": f"{in_use / 1e6:.1f}",
            })
        return out

    def log(self) -> None:
        from stgraph_tpu_torch.utils.data_table import DataTable

        dt = DataTable(f"torch devices (backend={self.backend})", _COLUMNS)
        for r in self.rows():
            dt.add_row([r[k] for k in dt.column_names])
        dt.display()
