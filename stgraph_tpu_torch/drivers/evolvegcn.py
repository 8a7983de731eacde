"""EvolveGCN: temporal node regression with evolving GCN weights.

The counterpart of ``benchmarking/evolvegcn/train.py``: EvolveGCN-O or -H
(``--variant o|h``) with ``lags`` (``--feat_size``) input features and
``--num_hidden`` outputs, a one-unit ``nn.Linear`` head on ``relu`` of its
output, and one Adam step an epoch. The epoch's loss is the mean over every
timestep of its MSE; the GCN weight is threaded across the timesteps from
the ``weight`` parameter, so the gradient reaches it through every GRU step
(full BPTT). Where JAX scans the timesteps inside one jitted step, the port
runs a Python loop over them. The datasets are the script's: WikiMath
(``lags=feat_size``) and WindmillOutput, always ``size="small"``. The
feature windows are built in numpy and copied to the device once.

``--impl`` is the layer's own aggregation field ('auto' | 'torch' | 'dense'
| 'kernel'; 'kernel' is JAX's 'pallas'): 'auto' takes the dense adjacency
on these graphs, 'kernel' launches K1 and K2 once a timestep each.

    python -m stgraph_tpu_torch.drivers.evolvegcn --variant h --dataset wikimath --impl kernel
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from stgraph_tpu_torch.drivers.static_temporal_tgcn import load_dataset
from stgraph_tpu_torch.graph import StaticGraph
from stgraph_tpu_torch.nn import EvolveGCNH, EvolveGCNO
from stgraph_tpu_torch.nn.tgcn import _lecun_dense
from stgraph_tpu_torch.utils import DataTable
from stgraph_tpu_torch.utils.cache import setup_compilation_cache
from stgraph_tpu_torch.utils.device import resolve_device
from stgraph_tpu_torch.utils.fetch import fetch_float

__all__ = ["EvolveGCNTrainer", "load_evolvegcn_dataset", "run"]


def load_evolvegcn_dataset(name: str, lags: int, cutoff: Optional[int], cache_dir: Optional[str] = None):
    """The script's dataset switch: ``wikimath``, or any ``windmill*`` name
    for WindmillOutput ``size="small"``."""
    if name == "wikimath":
        return load_dataset("wikimath", lags, cutoff, cache_dir)
    if name.startswith("windmill"):
        return load_dataset("windmill", lags, cutoff, cache_dir)
    raise ValueError(f"unknown dataset {name}")


class EvolveGCNTrainer:
    """The script's model, optimiser and data over one dataset.

    ``variant`` is ``"o"`` or ``"h"``; ``device`` defaults to CUDA. The
    parameters are drawn on the CPU from ``seed`` (the conv's initialisers,
    then a lecun-normal head with a zero bias) and moved to ``device``, so a
    seed gives every device the same model (under one torch version: the
    truncated-normal draws differ between versions).
    """

    def __init__(self, data, variant: str, lags: int, hidden: int, lr: float = 1e-2, impl: str = "auto",
                 device=None, seed: int = 0) -> None:
        dev = resolve_device(device)
        if variant not in ("o", "h"):
            raise ValueError(f"unknown variant {variant!r}: 'o' or 'h'")
        self.device, self.variant, self.lags, self.hidden = dev, variant, lags, hidden
        n = data.gdata["num_nodes"]
        self.num_nodes = n
        self.graph = StaticGraph(data.get_edges(), data.get_edge_weights(), n, device=dev)
        targets = np.stack(data.get_all_targets()).astype(np.float32)
        total = targets.shape[0] - lags
        self.total = total
        feats = np.stack([targets[i:i + lags].T for i in range(total)])  # (T, N, lags)
        self.feats = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
        self.ys = torch.from_numpy(np.ascontiguousarray(targets[lags:])).to(dev)
        gen = torch.Generator().manual_seed(seed)
        cls = EvolveGCNO if variant == "o" else EvolveGCNH
        self.conv = cls(lags, hidden, impl=impl, device="cpu", generator=gen).to(dev)
        self.head = _lecun_dense(hidden, 1, "cpu", gen).to(dev)
        self.opt = torch.optim.Adam(list(self.conv.parameters()) + list(self.head.parameters()), lr=lr)

    def timestep(self, w: Optional[torch.Tensor], t: int):
        """Timestep ``t`` from the evolving weight ``w`` (None: the
        ``weight`` parameter): (its MSE, the weight after it)."""
        out, w = self.conv(self.graph, self.feats[t], weight=w)
        y_hat = self.head(torch.relu(out))[:, 0]
        return ((y_hat - self.ys[t]) ** 2).mean(), w

    def loss(self, steps: Optional[int] = None):
        """The mean MSE of the first ``steps`` timesteps (default all), the
        weight threaded from the ``weight`` parameter, with its autograd
        graph; returns (loss, the weight after the last timestep)."""
        w, losses = None, []
        for t in range(self.total if steps is None else min(steps, self.total)):
            loss, w = self.timestep(w, t)
            losses.append(loss)
        return torch.stack(losses).mean(), w

    def backward(self, steps: Optional[int] = None):
        """``loss(steps)`` and its backward (the gradients left in the
        parameters' ``.grad``); returns the detached (loss, weight)."""
        self.opt.zero_grad(set_to_none=True)
        loss, w = self.loss(steps)
        loss.backward()
        return loss.detach(), w.detach()

    def epoch(self) -> torch.Tensor:
        """One epoch: the loss over every timestep, its backward and one Adam
        step. Returns the loss (before the step, as JAX's epoch returns it)
        as a device scalar."""
        loss, _ = self.backward()
        self.opt.step()
        return loss


def run(variant: str = "o", dataset: str = "wikimath", num_epochs: int = 10, num_hidden: int = 32,
        feat_size: int = 8, cutoff_time: Optional[int] = None, lr: float = 1e-2, impl: str = "auto", device=None,
        cache_dir: Optional[str] = None, seed: int = 0) -> dict:
    """The script's run: ``num_epochs`` epochs, the table of epoch, MSE and
    seconds, the average epoch time over epochs >= 3 and ``^^^0^^^<avg>``.
    Returns the epochs' MSEs and seconds."""
    dev = resolve_device(device)
    d = load_evolvegcn_dataset(dataset, feat_size, cutoff_time, cache_dir)
    trainer = EvolveGCNTrainer(d, variant, feat_size, num_hidden, lr, impl, dev, seed)
    table = DataTable(f"EvolveGCN-{variant.upper()} {dataset}", ["epoch", "mse", "time (s)"])
    mses, times = [], []
    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        loss = trainer.epoch()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        mses.append(fetch_float(loss))
        table.add_row([epoch, f"{mses[-1]:.6f}", f"{times[-1]:.4f}"])
    table.display()
    avg = float(np.mean(times[3:])) if len(times) > 3 else 0.0
    print(f"avg epoch time (>=3): {avg:.5f}s")
    print(f"^^^0^^^{avg:.6f}")
    return {"mse": mses, "epoch_s": times, "avg_epoch_s": avg, "timesteps": trainer.total}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("EvolveGCN benchmark")
    ap.add_argument("--variant", default="o", choices=["o", "h"])
    ap.add_argument("--dataset", default="wikimath")
    ap.add_argument("--num_epochs", type=int, default=10)
    ap.add_argument("--num_hidden", type=int, default=32)
    ap.add_argument("--feat_size", type=int, default=8)
    ap.add_argument("--cutoff_time", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--impl", default="auto", choices=["auto", "torch", "dense", "kernel"])
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    setup_compilation_cache()
    return run(args.variant, args.dataset, args.num_epochs, args.num_hidden, args.feat_size, args.cutoff_time,
               args.lr, args.impl, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
