"""K1 on the card against its plain version, and the GCN forward on CUDA
against the CPU. Marked ``cuda``: they skip where no card is present. On a
machine with a card and without jax they run without the suite's conftest:
``python -m pytest tests/test_torch_cuda.py --noconftest``.

Tolerance: the kernel rounds as its plain version does (a bf16 stream
rounds features, weights and products to bf16 and sums in f32), so only
the order of f32 sums differs: 1e-4 of the output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from stgraph_tpu_torch.graph.csr import build_csr
from stgraph_tpu_torch.graph.static_graph import StaticGraph
from stgraph_tpu_torch.nn import GCNConv
from stgraph_tpu_torch.ops.spmm_kernels import ROW_CHUNK, spmm_rowmask, spmm_rowmask_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the K1 kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _graph(rng, n, e, hub_deg):
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - 50, e)  # 50 empty rows
    dst[:hub_deg] = 7  # a hub row split across several warps
    return src, dst


@pytest.mark.parametrize("f", [47, 100, 128, 130])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("stream", [None, torch.bfloat16])
def test_k1_matches_plain_on_the_card(cuda, rng, f, weighted, stream):
    n, e = 3000, 60_000
    src, dst = _graph(rng, n, e, hub_deg=5 * ROW_CHUNK + 3)
    csr = build_csr(src, dst, n, device=cuda)
    x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.random(csr.capacity).astype(np.float32)).to(cuda) if weighted else None
    before = spmm_rowmask.launches
    out, _ = spmm_rowmask(csr, w, x, stream_dtype=stream)
    torch.cuda.synchronize()
    assert spmm_rowmask.launches == before + 1
    ref = spmm_rowmask_plain(csr, w, x, stream)
    err = (out - ref).abs().max().item()
    assert err <= 1e-4 * max(1.0, ref.abs().max().item()), err
    assert not out[n - 50 :].any()


def test_gcn_forward_on_cuda_matches_cpu(cuda, rng):
    n, e = 5000, 250_000  # above the bf16-stream threshold: K1 streams bf16
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    x = rng.standard_normal((n, 100)).astype(np.float32)
    conv = GCNConv(100, 128, activation=torch.relu, impl="kernel", device="cpu",
                   generator=torch.Generator().manual_seed(0))
    conv_cuda = GCNConv(100, 128, activation=torch.relu, impl="kernel", device=cuda)
    conv_cuda.load_state_dict(conv.state_dict())
    before = spmm_rowmask.launches
    with torch.inference_mode():
        ref = conv(StaticGraph(edges, None, n, device="cpu"), torch.from_numpy(x))
        out = conv_cuda(StaticGraph(edges, None, n, device=cuda), torch.from_numpy(x).to(cuda)).cpu()
    assert spmm_rowmask.launches == before + 1
    # h @ W sums in another order on the card, so a gathered value may round
    # to the neighbouring bf16 number: a bf16 ulp of one term, not 1e-4
    assert (out - ref).abs().max().item() <= 1e-2 * max(1.0, ref.abs().max().item())
