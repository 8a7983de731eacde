"""Static-temporal TGCN: node regression over a fixed graph.

The counterpart of ``benchmarking/static-temporal-tgcn/train.py``: the
dataset switch (WikiMath, WindmillOutput small / medium / large, HungaryCP,
PedalMe, MontevideoBus), features as a sliding window of ``feat_size``
(lags) past targets, ``TGCN(lags, hidden)`` with an ``nn.Linear(hidden, 1)``
head and ``torch.optim.Adam`` over both, truncated BPTT through
``--backprop_every`` windows with one optimiser step a window, the epoch's
MSE and time, the OOM row and the CSV row.

Where JAX scans a window inside one jitted step, the port runs a Python
loop over its timesteps. The loss of a window is the mean of its
timesteps' MSEs; JAX pads the last window and masks the padding, which
gives the same loss and gradients as the port's shorter last window. The
hidden state leaves a window detached (JAX's ``stop_gradient``).
``--remat`` wraps each timestep in ``torch.utils.checkpoint`` (JAX's
``jax.checkpoint``): the backward recomputes its forward, so on the kernel
route K1 runs twice as often. The feature windows are built in numpy and
copied to the device once.

``bench_tgcn_epoch`` is ``bench.py``'s TGCN epoch on the port: TGCN(8, 16)
and a one-unit head on WindmillOutput ``size="small", lags=8,
cutoff_time=100``, the MSE averaged over every timestep, one backward an
epoch and no optimiser step.

    python -m stgraph_tpu_torch.drivers.static_temporal_tgcn --dataset windmill_large \\
        --feat_size 80 --num_hidden 160 --cutoff_time 3000 --backprop_every 1000 --impl kernel
"""

from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from stgraph_tpu_torch.graph import StaticGraph
from stgraph_tpu_torch.nn import TGCN
from stgraph_tpu_torch.nn.tgcn import _lecun_dense
from stgraph_tpu_torch.utils import DataTable
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["StaticTemporalTrainer", "bench_tgcn_epoch", "load_dataset", "run"]


def load_dataset(name: str, lags: int, cutoff: Optional[int], cache_dir: Optional[str] = None):
    """The script's dataset switch (``windmill`` alone is the small size)."""
    from stgraph_tpu_torch import dataset as D

    name = name.lower()
    kw = dict(lags=lags, cutoff_time=cutoff, cache_dir=cache_dir)
    if name in ("wiki", "wikimath"):
        return D.WikiMathDataLoader(**kw)
    if name.startswith("windmill"):
        size = name.split("_")[1] if "_" in name else "small"
        return D.WindmillOutputDataLoader(size=size, **kw)
    if name in ("hungarycp", "hungary"):
        return D.HungaryCPDataLoader(**kw)
    if name == "pedalme":
        return D.PedalMeDataLoader(**kw)
    if name in ("monte", "montevideobus"):
        return D.MontevideoBusDataLoader(**kw)
    raise ValueError(f"unknown dataset {name}")


class StaticTemporalTrainer:
    """The script's model, optimiser and windows over one dataset.

    ``data`` is a static-temporal loader; ``device`` defaults to CUDA. The
    parameters are drawn on the CPU from ``seed`` (flax's initialisers:
    ``GCNConv`` xavier-uniform, the dense layers lecun-normal, zero biases)
    and moved to ``device``, so a seed gives every device the same model.
    """

    def __init__(self, data, lags: int, hidden: int, backprop_every: int = 0, lr: float = 1e-2,
                 impl: str = "auto", remat: bool = False, device=None, seed: int = 0) -> None:
        dev = resolve_device(device)
        self.device, self.lags, self.hidden, self.remat = dev, lags, hidden, remat
        n = data.gdata["num_nodes"]
        self.num_nodes = n
        self.graph = StaticGraph(data.get_edges(), data.get_edge_weights(), n, device=dev)
        self.ew = torch.from_numpy(np.asarray(data.get_edge_weights(), np.float32)).to(dev)
        targets = np.stack(data.get_all_targets()).astype(np.float32)
        if targets.ndim != 2:
            targets = targets.reshape(targets.shape[0], -1)
        total = targets.shape[0] - lags
        self.total = total
        feats = np.stack([targets[i:i + lags].T for i in range(total)])  # (T', N, lags)
        self.feats = torch.from_numpy(np.ascontiguousarray(feats)).to(dev)
        self.ys = torch.from_numpy(np.ascontiguousarray(targets[lags:])).to(dev)
        gen = torch.Generator().manual_seed(seed)
        self.model = TGCN(lags, hidden, impl=impl, device="cpu", generator=gen).to(dev)
        self.head = _lecun_dense(hidden, 1, "cpu", gen).to(dev)
        self.opt = torch.optim.Adam(list(self.model.parameters()) + list(self.head.parameters()), lr=lr)
        self.window = backprop_every or total
        self.num_windows = -(-total // self.window)

    def window_range(self, wi: int) -> range:
        return range(wi * self.window, min((wi + 1) * self.window, self.total))

    def zero_hidden(self) -> torch.Tensor:
        return torch.zeros(self.num_nodes, self.hidden, device=self.device)

    def _timestep(self, h, x, y):
        h = self.model(self.graph, x, edge_weight=self.ew, hidden=h)
        return h, ((self.head(h)[:, 0] - y) ** 2).mean()

    def window_loss(self, hidden: torch.Tensor, wi: int):
        """(the mean of window ``wi``'s timestep MSEs, the hidden state after
        it), with the autograd graph of the window."""
        losses = []
        for t in self.window_range(wi):
            if self.remat:
                hidden, loss = checkpoint(self._timestep, hidden, self.feats[t], self.ys[t], use_reentrant=False)
            else:
                hidden, loss = self._timestep(hidden, self.feats[t], self.ys[t])
            losses.append(loss)
        return torch.stack(losses).mean(), hidden

    def window_backward(self, hidden: torch.Tensor, wi: int):
        """Window ``wi``'s loss and backward from ``hidden`` (the gradients
        left in the parameters' ``.grad``); returns (loss, the detached
        hidden state after the window)."""
        self.opt.zero_grad(set_to_none=True)
        loss, hidden = self.window_loss(hidden, wi)
        loss.backward()
        return loss.detach(), hidden.detach()

    def epoch(self) -> float:
        """One epoch: a backward and an Adam step a window. Returns the MSE
        over the epoch's timesteps (each window's loss weighted by its
        length)."""
        hidden, tot = self.zero_hidden(), 0.0
        for wi in range(self.num_windows):
            loss, hidden = self.window_backward(hidden, wi)
            self.opt.step()
            tot += loss.item() * len(self.window_range(wi))
        return tot / self.total


def run(dataset: str = "wikimath", num_epochs: int = 10, num_hidden: int = 64, feat_size: int = 8,
        backprop_every: int = 0, cutoff_time: Optional[int] = None, lr: float = 1e-2, impl: str = "auto",
        results_csv: str = "", remat: bool = False, device=None, cache_dir: Optional[str] = None,
        seed: int = 0) -> dict:
    """The script's run: ``num_epochs`` epochs, the table, the average epoch
    time over epochs >= 3, ``^^^0^^^<avg>`` and the CSV row. Returns the
    epochs' MSEs and seconds (``oom`` True after an out-of-memory row)."""
    dev = resolve_device(device)
    d = load_dataset(dataset, feat_size, cutoff_time, cache_dir)
    trainer = StaticTemporalTrainer(d, feat_size, num_hidden, backprop_every, lr, impl, remat, dev, seed)
    table = DataTable(f"TGCN {dataset}", ["epoch", "mse", "time (s)"])
    mses, times = [], []
    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        try:
            mse = trainer.epoch()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        except torch.cuda.OutOfMemoryError:
            table.add_row([epoch, "OOM", "OOM"])
            table.display()
            print("^^^OOM^^^OOM")
            return {"oom": True, "mse": mses, "epoch_s": times}
        times.append(time.perf_counter() - t0)
        mses.append(mse)
        table.add_row([epoch, f"{mse:.6f}", f"{times[-1]:.4f}"])
    table.display()
    avg = float(np.mean(times[3:])) if len(times) > 3 else 0.0
    print(f"avg epoch time (>=3): {avg:.5f}s")
    print(f"^^^0^^^{avg:.6f}")
    if results_csv:
        os.makedirs(os.path.dirname(results_csv) or ".", exist_ok=True)
        new = not os.path.exists(results_csv)
        with open(results_csv, "a", newline="") as fh:
            w = csv.writer(fh)
            if new:
                w.writerow(["dataset", "feat_size", "backprop_every", "epoch_time_s", "mse"])
            w.writerow([dataset, feat_size, backprop_every, avg, mses[-1] if mses else float("nan")])
    return {"oom": False, "mse": mses, "epoch_s": times, "avg_epoch_s": avg, "timesteps": trainer.total,
            "windows": trainer.num_windows}


def bench_tgcn_epoch(cutoff: int = 100, iters: int = 10, warmup: int = 2, device=None,
                     cache_dir: Optional[str] = None, seed: int = 0, trainer: Optional[StaticTemporalTrainer] = None
                     ) -> dict:
    """``bench.py``'s TGCN epoch: seconds an epoch (host clock over ``iters``
    epochs after ``warmup``, ending in a synchronise), the timesteps and the
    last loss. ``trainer`` reuses a ``tgcn_epoch_trainer``."""
    trainer = trainer or tgcn_epoch_trainer(cutoff, device, cache_dir, seed)
    dev = trainer.device

    def epoch():
        loss, _ = trainer.window_backward(trainer.zero_hidden(), 0)
        return loss

    for _ in range(warmup):
        loss = epoch()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        loss = epoch()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"tgcn_epoch_s": (time.perf_counter() - t0) / iters, "timesteps": trainer.total, "loss": loss.item()}


def tgcn_epoch_trainer(cutoff: int = 100, device=None, cache_dir: Optional[str] = None, seed: int = 0
                       ) -> StaticTemporalTrainer:
    """``bench_tgcn_epoch``'s model and data: TGCN(8, 16) and a one-unit head
    on WindmillOutput small at ``cutoff``, one window over every timestep."""
    from stgraph_tpu_torch.dataset import WindmillOutputDataLoader

    dev = resolve_device(device)
    wind = WindmillOutputDataLoader(size="small", lags=8, cutoff_time=cutoff, cache_dir=cache_dir)
    return StaticTemporalTrainer(wind, 8, 16, device=dev, seed=seed)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("static-temporal TGCN benchmark")
    ap.add_argument("--dataset", default="wikimath")
    ap.add_argument("--num_epochs", type=int, default=10)
    ap.add_argument("--num_hidden", type=int, default=64)
    ap.add_argument("--feat_size", type=int, default=8, help="lags window = features")
    ap.add_argument("--backprop_every", type=int, default=0, help="truncated-BPTT window (0 = whole sequence)")
    ap.add_argument("--cutoff_time", type=int, default=None)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--impl", default="auto", choices=["auto", "torch", "dense", "kernel"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--results_csv", default="")
    ap.add_argument("--remat", action="store_true", help="checkpoint each timestep (trade FLOPs for memory)")
    args = ap.parse_args(argv)
    return run(args.dataset, args.num_epochs, args.num_hidden, args.feat_size, args.backprop_every, args.cutoff_time,
               args.lr, args.impl, args.results_csv, args.remat, device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
