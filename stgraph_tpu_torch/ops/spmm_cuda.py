"""Kernel SpMM entry point: the counterpart of ``stgraph_tpu/ops/spmm_pallas.py``
(``spmm`` ``:601-666``, ``_stream_dtype`` ``:592-598`` and
``_make_rowmask_spmm`` ``:420-491``) for the forward pass. It is named for
its route, as the JAX module is; ``ops.spmm`` is the function that
``ops/__init__`` exports.

The forward launches K1 (``ops.spmm_kernels.spmm_rowmask``) inside a
``torch.autograd.Function``. Its backward needs K1 on the transpose CSR
(unweighted) and K2 (weighted); both come with the training slice, so on
CUDA the backward raises. CPU tensors take K1's plain version, which
autograd differentiates. The JAX package's ``src_ids`` variant exists only
for the TPU's compile-request limit and has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from stgraph_tpu_torch.graph.csr import CSR
from stgraph_tpu_torch.ops import message as _msg
from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask

__all__ = ["spmm"]

# f32 inputs on graphs at least this large stream bf16 through K1 (f32
# sums), as in the JAX package: it halves the dominant gathered stream.
_BF16_STREAM_MIN_EDGES = 200_000


def _stream_dtype(csr: CSR, dt: torch.dtype) -> Optional[torch.dtype]:
    if dt == torch.float32 and csr.capacity >= _BF16_STREAM_MIN_EDGES:
        return torch.bfloat16
    return None


class _RowmaskSpmm(torch.autograd.Function):
    """K1 forward; the backward is the training slice's work."""

    @staticmethod
    def forward(ctx, h, w, csr, stream_dtype):
        out, _ = spmm_rowmask(csr, w, h, stream_dtype=stream_dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the SpMM backward on CUDA needs K1 on the transpose CSR "
            "(unweighted) and K2 (weighted), which come with the training slice"
        )


def spmm(
    csr: CSR,
    node_feat: torch.Tensor,
    edge_weight: Optional[torch.Tensor] = None,
    reduce: str = "sum",
) -> torch.Tensor:
    """Kernel SpMM matching ``ops.message.spmm``'s contract.

    Sums over (N, F) features go through K1; max/min/mean and 3-D features
    take the torch path as in the JAX package, except multi-head weighted
    sums on CUDA, which wait for the GAT slice's K1 modes.
    """
    if reduce == "sum" and node_feat.dim() == 3 and edge_weight is not None:
        if node_feat.device.type != "cpu":
            raise NotImplementedError("multi-head K1 comes with the GAT slice")
        return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    if reduce != "sum" or node_feat.dim() != 2:
        return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    w = None
    if edge_weight is not None:
        w = edge_weight.reshape(-1)
        if w.shape[0] != csr.capacity:
            return _msg.spmm(csr, node_feat, edge_weight, reduce=reduce, impl="torch")
    stream = _stream_dtype(csr, node_feat.dtype)
    if node_feat.device.type == "cpu":
        out, _ = spmm_rowmask(csr, w, node_feat, stream_dtype=stream)
    else:
        out = _RowmaskSpmm.apply(node_feat, w, csr, stream)
    return out.to(node_feat.dtype)
