"""Dynamic-temporal TGCN: link prediction over a changing graph.

The counterpart of ``benchmarking/dynamic-temporal-tgcn/train.py``:
England-COVID (or a DTDG JSON file of ``benchmarking/dataset/``, read by
``_SyntheticDTDG``), ``TGCN(lags, hidden)``, a dot-product decoder, the
link loss (binary cross-entropy of the positive edges' scores and of as
many uniform negative pairs', over the real slots), ``torch.optim.Adam``
with one step an epoch over every timestep's loss, and the graph-store
switch ``--type``:

  * ``naive``: ``NaiveGraph``'s snapshot CSRs, snapshot ``t + lags`` for
    feature window ``t``;
  * ``delta``: ``DeltaGraph.get_graph``, the same alignment;
  * ``delta-scan``: the edge store seeded from ``snapshot_store(lags - 1)``,
    each timestep's staged delta applied with ``apply_delta`` inside the
    loop, then ``edge_store_to_csr``;
  * ``lazy-scan``: the lazy store pair seeded from the same snapshot, the
    staged deltas trimmed to the window's largest batch and tail logs 8
    batches wide, ``apply_delta_lazy_pair`` inside the loop; ``GCNConv``
    aggregates from the pair (K6, K7) and the positive edges are the fwd
    store's main and tail slots;
  * ``pma-scan``: the PMA store pair (chunks of ``PMA_CHUNK`` slots, twice
    the capacity's chunks) built from the same snapshot's live slots, one
    ``apply_delta_pair`` a timestep over the staged deltas as they are;
    ``GCNConv`` aggregates from the pair (K6, K7) and the positive edges are
    the fwd store's flat view, sentinels masked. Each update reads one flag
    a store on the host (``graph/pma_store.py``).

Where JAX scans the epoch inside one jitted step, the port runs a Python
loop over the timesteps. The negatives come from an explicit
``torch.Generator`` (``negatives`` replaces it: the tests feed both
packages the same draws). The graph build time and the stores' update
counters are printed as the script prints them.

    python -m stgraph_tpu_torch.drivers.dynamic_temporal_tgcn --type delta-scan \\
        --feat_size 32 --num_hidden 64
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stgraph_tpu_torch.graph import DeltaGraph, NaiveGraph
from stgraph_tpu_torch.graph.delta_graph import EdgeStore, apply_delta, edge_store_to_csr
from stgraph_tpu_torch.nn import TGCN
from stgraph_tpu_torch.ops.dyn_spmm import (
    apply_delta_lazy_pair,
    apply_delta_pair,
    lazy_pair_from_edges,
    pma_pair_from_edges,
)
from stgraph_tpu_torch.utils import DataTable
from stgraph_tpu_torch.utils.device import resolve_device

__all__ = ["DynamicTemporalTrainer", "GRAPH_TYPES", "link_loss", "load_dataset", "run"]

GRAPH_TYPES = ("naive", "delta", "delta-scan", "pma-scan", "lazy-scan")
PMA_CHUNK = 256  # train.py's S


class _SyntheticDTDG:
    """Adapter over a DTDG JSON file: lags-windowed degree features.

    Reads both of the JAX package's schemas: snapshot lists
    (``dataset_builder.py``: ``edge_index[t]`` is timestamp t's whole edge
    list) and SNAP update streams (``preprocessing.py``: ``edge_index[t]``
    is ``{"add": [...], "delete": [...], "neg": [...]}``, replayed here into
    snapshots). The feature of a node is a lags window of its out-degree,
    scaled by the largest; the target is the next step's.
    """

    def __init__(self, path: str, lags: int) -> None:
        with open(path) as fh:
            data = json.load(fh)
        t_count = int(data["time_periods"])
        em = data["edge_mapping"]
        first = em["edge_index"][str(0)]
        if isinstance(first, dict):  # add/delete update stream
            self._edges = []
            current: set = set()
            for t in range(t_count):
                upd = em["edge_index"][str(t)]
                current |= {tuple(e) for e in upd["add"]}
                current -= {tuple(e) for e in upd.get("delete", [])}
                self._edges.append(sorted(current))
        else:
            self._edges = [[tuple(e) for e in em["edge_index"][str(t)]] for t in range(t_count)]
        ws = em.get("edge_weight", {})
        self._weights = [ws.get(str(t), [1.0] * len(self._edges[t])) for t in range(t_count)]
        n = 1 + max((max(max(e) for e in edges) for edges in self._edges if edges), default=0)
        deg = np.zeros((t_count, n), np.float32)
        for t, edges in enumerate(self._edges):
            for s, _ in edges:
                deg[t, s] += 1.0
        deg /= max(deg.max(), 1.0)
        self._feats = [deg[t:t + lags].T for t in range(t_count - lags)]  # (N, lags) a step
        self._targets = [deg[t + lags] for t in range(t_count - lags)]
        self.gdata = {"num_nodes": n}

    def get_edges(self):
        return self._edges

    def get_edge_weights(self):
        return self._weights

    def get_all_features(self):
        return self._feats

    def get_all_targets(self):
        return self._targets


def load_dataset(name: str, lags: int, cache_dir: Optional[str] = None):
    """England-COVID, or a DTDG JSON file (a name ending in ``.json``)."""
    if name.endswith(".json"):
        return _SyntheticDTDG(name, lags)
    from stgraph_tpu_torch.dataset import EnglandCovidDataLoader

    return EnglandCovidDataLoader(lags=lags, cache_dir=cache_dir)


def link_loss(h, rows, cols, mask, neg_s, neg_d) -> torch.Tensor:
    """Binary cross-entropy of the dot-product scores of the edges (``cols``
    the sources, ``rows`` the destinations, sentinels clamped) and of the
    negative pairs, summed over the slots ``mask`` marks and divided by
    their count."""
    # index_select, whose backward is an index_add: indexing's backward
    # (a sort-based accumulate) took most of an epoch on the H100
    pos = (h.index_select(0, cols) * h.index_select(0, rows)).sum(-1)
    neg = (h.index_select(0, neg_s) * h.index_select(0, neg_d)).sum(-1)
    loss = (F.binary_cross_entropy_with_logits(pos, torch.ones_like(pos), reduction="none")
            + F.binary_cross_entropy_with_logits(neg, torch.zeros_like(neg), reduction="none"))
    return torch.where(mask, loss, 0.0).sum() / mask.sum().clamp(min=1)


class DynamicTemporalTrainer:
    """The script's graph store, model and optimiser over one sequence.

    ``edge_lists`` and ``weight_lists`` (None: unweighted) are the
    timestamps' graphs and ``feats`` the (N, lags) feature windows; window
    ``t`` meets snapshot ``t + lags``. The parameters are drawn on the CPU
    from ``seed`` and moved to ``device`` (default CUDA). ``negatives(t,
    slots)`` gives timestep ``t``'s (sources, destinations) of the negative
    pairs, one a positive slot; by default uniform draws from a generator on
    ``device`` seeded with ``seed + 7``.
    """

    def __init__(self, edge_lists: Sequence, weight_lists: Optional[Sequence], feats: Sequence,
                 graph_type: str = "naive", lags: int = 8, hidden: int = 32, lr: float = 1e-2, device=None,
                 seed: int = 0, negatives: Optional[Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]] = None
                 ) -> None:
        if graph_type not in GRAPH_TYPES:
            raise ValueError(f"unknown graph type {graph_type!r}; one of {GRAPH_TYPES}")
        dev = resolve_device(device)
        self.device, self.graph_type, self.lags, self.hidden = dev, graph_type, lags, hidden
        t0 = time.perf_counter()
        cls = NaiveGraph if graph_type == "naive" else DeltaGraph
        self.store = cls(edge_lists, weight_lists, device=dev)
        self.build_s = time.perf_counter() - t0
        self.weighted = weight_lists is not None
        n = self.num_nodes = self.store.get_num_nodes()
        self.steps = len(feats)
        self.xs = torch.from_numpy(np.ascontiguousarray(np.stack(feats), np.float32)).to(dev)
        if graph_type in ("delta-scan", "lazy-scan", "pma-scan"):
            self._stage_deltas()
        gen = torch.Generator().manual_seed(seed)
        self.model = TGCN(lags, hidden, device="cpu", generator=gen).to(dev)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        self.gen = torch.Generator(device=dev).manual_seed(seed + 7)
        self.negatives = negatives or (lambda t, slots: tuple(
            torch.randint(0, n, (slots,), device=dev, generator=self.gen) for _ in range(2)))

    def _stage_deltas(self) -> None:
        g, lags, steps, n = self.store, self.lags, self.steps, self.num_nodes
        add, dele = (x[lags:lags + steps] for x in g.staged_deltas())
        add_w = g.staged_add_weights()
        add_w = None if add_w is None else add_w[lags:lags + steps]
        init = g.snapshot_store(lags - 1)
        if self.graph_type == "delta-scan":
            def t(a, dtype):
                return torch.from_numpy(np.asarray(a, dtype)).to(self.device)

            self.init_store = EdgeStore(t(init.rows, np.int32), t(init.cols, np.int32), t(init.num_edges, np.int64),
                                        n, None if init.weights is None else t(init.weights, np.float32))
        elif self.graph_type == "pma-scan":
            live = init.rows < n
            self.pair0 = pma_pair_from_edges(
                init.cols[live], init.rows[live], n, num_chunks=max(-(-g._capacity // PMA_CHUNK) * 2, 2),
                chunk_size=PMA_CHUNK, weights=None if init.weights is None else init.weights[live], device=self.device)
        else:
            # the window's largest real batch (one read at set-up, as the
            # script does): the staged batches are padded to the largest of
            # every timestamp, the first one's whole edge set included
            width = int(max((add[:, :, 0] < n).sum(1).max(), (dele[:, :, 0] < n).sum(1).max()))
            width = min(max(width, 16), add.shape[1])
            add, dele = add[:, :width], dele[:, :width]
            add_w = None if add_w is None else add_w[:, :width]
            self.width, self.tail_capacity = width, max(8 * width, 128)
            live = init.rows < n
            self.pair0 = lazy_pair_from_edges(
                init.cols[live], init.rows[live], n, capacity=g._capacity + self.tail_capacity,
                tail_capacity=self.tail_capacity, weights=None if init.weights is None else init.weights[live],
                device=self.device)
        self.add, self.dele, self.add_w = add, dele, add_w

    def update(self, graph, t: int):
        """The store after timestep ``t``'s staged delta (the scan types)."""
        a, d = self.add[t], self.dele[t]
        aw = None if self.add_w is None else self.add_w[t]
        if self.graph_type == "lazy-scan":
            return apply_delta_lazy_pair(graph, a[:, 0], a[:, 1], d[:, 0], d[:, 1], add_weights=aw)
        if self.graph_type == "pma-scan":
            return apply_delta_pair(graph, a[:, 0], a[:, 1], d[:, 0], d[:, 1], add_weights=aw)
        return apply_delta(graph, a[:, 1], a[:, 0], d[:, 1], d[:, 0], add_weights=aw)  # row = dst

    def timesteps(self):
        """Per timestep: (the graph the model takes, its edge weights or None,
        the positive slots' destinations and sources with sentinels clamped,
        and the mask of the real slots)."""
        if self.graph_type in ("naive", "delta"):
            for t in range(self.steps):
                csr = self.store.get_graph(t + self.lags)
                yield csr, self.store.get_edge_weights(t + self.lags), csr.rows_clamped, csr.cols_clamped, \
                    csr.edge_mask
        elif self.graph_type == "delta-scan":
            store = self.init_store
            for t in range(self.steps):
                store = self.update(store, t)
                csr = edge_store_to_csr(store, self.device)
                w = store.weights.reshape(-1, 1) if self.weighted else None
                yield csr, w, csr.rows_clamped, csr.cols_clamped, csr.edge_mask
        elif self.graph_type == "pma-scan":
            pair, n = self.pair0, self.num_nodes
            for t in range(self.steps):
                pair = self.update(pair, t)
                rows, cols, _ = pair.fwd.flatten()
                yield pair, None, rows.clamp(max=n - 1), cols.clamp(max=n - 1), rows < n
        else:
            pair, n = self.pair0, self.num_nodes
            for t in range(self.steps):
                pair = self.update(pair, t)
                st = pair.fwd
                rows = torch.cat([st.rows, st.tail_rows]).clamp(max=n - 1)
                cols = torch.cat([st.cols, st.tail_cols]).clamp(max=n - 1)
                yield pair, None, rows, cols, torch.cat([st.w, st.tail_w]) > 0

    def epoch_loss(self, hiddens: Optional[list] = None) -> torch.Tensor:
        """The mean of the timesteps' link losses, with the autograd graph of
        the epoch; ``hiddens`` collects the detached hidden states."""
        h = torch.zeros(self.num_nodes, self.hidden, device=self.device)
        losses = []
        for t, (graph, w, rows, cols, mask) in enumerate(self.timesteps()):
            h = self.model(graph, self.xs[t], edge_weight=w, hidden=h)
            if hiddens is not None:
                hiddens.append(h.detach())
            neg_s, neg_d = self.negatives(t, rows.shape[0])
            losses.append(link_loss(h, rows, cols, mask, neg_s, neg_d))
        return torch.stack(losses).mean()

    def epoch(self) -> torch.Tensor:
        """One epoch: the loss over every timestep, its backward and one Adam
        step. Returns the (detached) loss."""
        self.opt.zero_grad(set_to_none=True)
        loss = self.epoch_loss()
        loss.backward()
        self.opt.step()
        return loss.detach()

    def updates_only(self) -> None:
        """The graph side of an epoch alone: every timestep's snapshot or
        update (and CSR), no model."""
        for _ in self.timesteps():
            pass


def run(dataset: str = "england_covid", graph_type: str = "naive", num_epochs: int = 5, num_hidden: int = 32,
        feat_size: int = 8, lr: float = 1e-2, device=None, cache_dir: Optional[str] = None, seed: int = 0) -> dict:
    """The script's run: the table, the graph build time with the update
    counters, the average epoch time over epochs >= 1 and ``^^^0^^^<avg>``.
    Returns the epochs' losses and seconds."""
    dev = resolve_device(device)
    d = load_dataset(dataset, feat_size, cache_dir)
    trainer = DynamicTemporalTrainer(d.get_edges(), d.get_edge_weights(), d.get_all_features(), graph_type,
                                     feat_size, num_hidden, lr, dev, seed)
    table = DataTable(f"DTDG link-pred ({graph_type})", ["epoch", "bce", "time (s)"])
    losses, times = [], []
    for epoch in range(num_epochs):
        t1 = time.perf_counter()
        loss = trainer.epoch().item()
        times.append(time.perf_counter() - t1)
        losses.append(loss)
        table.add_row([epoch, f"{loss:.5f}", f"{times[-1]:.4f}"])
    table.display()
    avg = float(np.mean(times[1:])) if len(times) > 1 else 0.0
    g = trainer.store
    print(f"graph build time: {trainer.build_s:.4f}s  (fwd update counters: {g.get_fwd_graph_time():.4f}s, "
          f"bwd: {g.get_bwd_graph_time():.4f}s)")
    print(f"avg epoch time (>=1): {avg:.5f}s")
    print(f"^^^0^^^{avg:.6f}")
    return {"loss": losses, "epoch_s": times, "avg_epoch_s": avg, "build_s": trainer.build_s,
            "timesteps": trainer.steps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser("dynamic-temporal TGCN benchmark")
    ap.add_argument("--dataset", default="england_covid")
    ap.add_argument("--type", default="naive", choices=list(GRAPH_TYPES))
    ap.add_argument("--num_epochs", type=int, default=5)
    ap.add_argument("--num_hidden", type=int, default=32)
    ap.add_argument("--feat_size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    return run(args.dataset, args.type, args.num_epochs, args.num_hidden, args.feat_size, args.lr,
               device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
