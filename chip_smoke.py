#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``stgraph_tpu_torch``) on one NVIDIA GPU.

Phases (any failure exits nonzero and prints no result line):

1. environment: torch/CUDA versions, the card's name and power limit, the
   nvcc version, and the time to build every kernel from the sources (one
   nvcc per source, all at once);
2. K1 against its plain version on the card, at F in {47, 100, 128},
   weighted and unweighted, f32 and bf16 streams, on a graph with empty rows
   and one hub row;
3. K2 against its plain version on the card, at F in {7, 16, 47, 100, 128,
   130}, f32 and bf16 streams, on the transpose of a graph with empty rows
   and a hub row in both directions;
4. serving, the first main path: a 3-layer GCN (100 -> 128 -> 128 -> 47,
   ReLU between layers, random weights from ``--seed`` carried through
   ``convert.py``) behind a ``Predictor`` on the synthetic ogbn-products
   graph (``--scale 1.0``: 2,449,029 nodes, 123,718,280 edges, so K1 and K2
   stream bf16) answers 3 requests. The launch counts are set to 0 just
   before and read just after; K1 must grow by 3 a request, K2 not at all.
   Each layer's output in the first request is held against the plain
   formula on 4096 sampled destination rows (and the largest hub);
5. K1 at the main path's shapes: the kernel, its plain version (in edge
   blocks, to bound memory) and ``torch.sparse.mm`` as a timed yardstick,
   with the full outputs compared;
6. a profile of one request (device time by kernel, idle share);
7. K2 at the main path's shapes (F = 128 and 47 on the transpose of the
   full graph): the kernel, its plain version and ``torch.sparse.mm`` plus
   ``torch.sparse.sampled_addmm`` as a timed yardstick, full outputs
   compared;
8. training, the second main path: the served GCN class with
   ``F.cross_entropy`` and ``torch.optim.AdamW(lr=1e-2, weight_decay=5e-4)``
   on the full graph, 1 warm step and 5 timed ones. The counts are set to 0
   just before the timed steps and read just after: 3 K1 and 3 K2 launches
   a step; the loss must be finite and fall;
9. a profile of one training step;
10. the unweighted route (``bench.py``'s formulation,
    ``spmm(csr, (h @ W) * norm) * norm``): one full-size step launches K1 6
    times (3 on the transpose) and K2 never;
11. checkpoint -> serve: the trained model and optimizer through
    ``Checkpointer``, ``Predictor.from_checkpoint`` answers one request,
    each layer held to its own forward on the same input;
12. the whole model at ``--scale 0.01`` against the plain torch path;
13. gradients at ``--scale 0.01`` against the plain torch path, for every
    parameter and for a ``GCNConv``'s edge weights;
14. Cora as ``benchmarking/gcn/train.py`` runs it (2 layers, hidden 16,
    AdamW, 200 epochs, the kernel route): train accuracy above 0.9;
15. TGCN on a 200k-edge weighted graph, 3 timesteps forward and backward,
    against the same run on the CPU's plain path;
16. K4, K8 (with and without its aux outputs) and K9 against their plain
    versions on the card, on K2's check graph, at (H, F) in {(8, 32),
    (1, 47), (8, 8), (4, 16)}, f32 and bf16 streams;
17. GAT serving, the third main path, on the graph the GCN phases built
    (their models and optimizer states released first): the GAT of
    ``benchmarking/gat/train.py`` at ``benchmarking/micro/ogbn_gat_bench.py``'s
    widths (GATConv(100, 32, 8 heads, ELU), heads concatenated to 256,
    GATConv(256, 47, 1 head), mean over the output heads; random weights
    from ``--seed`` through ``convert.py``) behind a ``Predictor`` answers
    3 requests, each launching K4 and K8 twice and K9 never;
18. K4, K8 and K9 at the main path's shapes (both layers' own scores and
    features, a random cotangent for K9): each kernel, its plain version (in
    edge blocks) and a library yardstick timed, full outputs compared;
19. GAT training, the fourth main path: ``F.cross_entropy`` and
    ``torch.optim.Adam(lr=5e-3)``, 1 warm step and 5 timed ones, each
    launching K4, K8 and K9 twice; the loss must be finite and fall;
20. a profile of one GAT training step;
21. the GAT model and its gradients at ``--scale 0.01`` against the plain
    torch path (the vertex program, with K3's and K4's plain versions);
22. Pubmed as ``benchmarking/gat/train.py --dataset pubmed`` runs it (8 heads
    x 8 hidden, 1 output head, Adam 5e-3, 200 epochs, the flash route on an
    f32 stream): train accuracy at least ``PUBMED_ACC_FLOOR``;
23. K6 and K7 against their plain versions on a flat store with sentinel
    slots spread through it, tombstones, empty rows and a 150k-slot hub row,
    weighted, unweighted and w = None, K6 at F in {8, 32, 128}, also on an
    adversarial store (an all-sentinel chunk, a row over three chunks with
    sentinels inside its run, a tombstone-only row across a chunk boundary,
    empty rows across one, rows after the last live slot); K6's chunk plan
    bit for bit against ``rowid_chunk_plan``, its output in a block
    poisoned with NaN;
24. dyn-step, the fifth main path: ``bench.py``'s ``bench_dyn`` on the
    port (the lazy store pair at 1.1M nodes, capacity 2.2M, 64 steps of 10k
    adds and 10k deletes, ``lazy_spmm`` at F = 128): one K6 a step; per-step
    times of update + aggregation, update alone, aggregation alone and K1 on
    the initial edges; after the 64 steps the live sets of both stores must
    equal the generator's;
25. K6 and K7 at that path's shapes: each kernel, its plain version and a
    library call timed, full outputs compared (K6 into a poisoned block, its
    plan bit for bit);
26. dtdg-training, the sixth main path, on England-COVID (weighted, 53
    timesteps) and the wiki-talk-shaped stream (unweighted, 4): the
    lazy-scan epoch of ``benchmarking/dynamic-temporal-tgcn/train.py``
    (TGCN 8 -> 32, link loss, Adam 1e-2), 1 warm and 4 timed epochs, each
    launching 6T K6 and 3T K7, the loss finite and falling; a profile of one
    epoch; K6 on both stores of the pair and K7 with ``lazy_norm``'s weights
    at the path's shapes against their plain versions; the hidden state at
    every timestep, the loss and one epoch's parameter gradients against the
    same TGCN over ``NaiveGraph`` snapshot CSRs (K1), to ``HIDDEN_TOL`` and
    ``DTDG_GRAD_TOL`` of the largest.

27. composed-serving, the seventh main path, on the ogbn graph after the
    GAT phases (run between 20 and 21): the GAT of ``benchmarking/gat/train.py``
    at the GAT paper's PPI widths (``--num_layers 3 --num_hidden 256
    --num_heads 4 --num_out_heads 6``: 100 -> 4x256 -> 4x256 -> 6x47, the
    heads of the last averaged), which misses the flash tilings and takes the
    composed route; 3 requests, each launching K4, K3 and K10 three times;
    each layer's output in the first request held against an f64
    recomputation on 1024 sampled rows and the largest hub; the peak device
    memory; a profile of one request; K3 and K10 at the first layer's shapes
    with its own weights and features (kernel, plain version, library calls:
    for K10 one ``torch.sparse.mm`` over the block-diagonal-by-head pattern
    and, beside it, H calls of one head each; full outputs compared, K3's in
    a poisoned block and bit-equal over two calls, with its device time and
    launches a call: ``k3_at_shape``);
28. K3 and K10 against their plain versions (run after 15): K3 at K in
    {1, 4, 6, 16} on the forward and transpose CSRs of a graph with a
    150k-edge hub in each direction, empty rows, empty row blocks and padding
    slots; K10 at (H, F) in {(4, 256), (6, 121), (3, 20), (3, 7), (40, 4)}
    on both blocked layouts (a block of over 10^5 slots in each), each
    output in a block poisoned with NaN, K3's bit-equal over two calls;
29. ppi-serving and ppi-training, the eighth and ninth main paths: the same
    model at the PPI widths (50 -> 4x256 -> 4x256 -> 6x121) on a synthetic
    graph of PPI's size (56,944 nodes, 818,716 edges; Chung-Lu degrees as in
    the ogbn synthesis): 3 requests (3 K4, 3 K3, 3 K10 each), 1 + 5
    Adam(5e-3) steps (3 K4, 9 K3, 6 K10 each), a profile of a step, and the
    logits and one step's gradients against the vertex program with K3's
    and K4's plain versions;
30. K3 and K10 at a PPI training step's shapes: kernel, plain version and
    library calls timed (K10's as in 27), full outputs compared in poisoned
    blocks (K3's as in 27);
31. pubmed-rowmask, the tenth main path (run after 22):
    ``benchmarking/gat/train.py --dataset pubmed --num_heads 32 --num_hidden
    4`` (500 -> 32 x 4 with ELU -> 1 x 3, Adam 5e-3, 200 epochs): the 32 x 4
    layer takes the composed route's rowmask branch, each epoch launching K5
    and K1 (heads, denominator) once forward, K2 (heads) once and K1's
    no-gather mode twice backward, and K4, K8 and K9 once for the 1 x 3
    layer; train accuracy at least ``PUBMED_ROWMASK_ACC_FLOOR``; one step's
    logits and gradients against the vertex program with every kernel's
    plain version;
32. K5 (bit for bit) and K1's no-gather mode (f32 and bf16 streams) at K in
    {17, 32, 130} on both CSRs of the composed check graph, and K1's heads
    and denominator modes and K2's heads mode at (H, F) in {(32, 4), (8, 64),
    (4, 128), (64, 2), (1, 384)}, f32 and bf16 streams, against their plain
    versions (run after 28);
33. rowmask-ppi, the eleventh main path (run after 30): ``sparse_gat_attention``
    at 32 x 4 on the PPI-sized graph (bf16 stream), forward and backward
    (K5, K1 and K2 once, the no-gather sum twice), the output and the three
    gradients against an f64 recomputation (``ROWMASK_OUT_TOL``,
    ``ROWMASK_SCORE_TOL``), then each of those kernels at the route's shapes
    against its plain version, timed with a library yardstick, its bound by
    bytes and the longest work item of its launch.

34. the in-kernel attention-dropout mask (``stg_edge_keep_mask``, the hash
    K8 and K9 run) against ``edge_keep_mask`` bit for bit over 1.6 * 10^8
    (edge, head) pairs, and K8 (with and without aux) and K9 in their
    dropout mode against their plain versions at rates 0.3 and 0.6 (in 16,
    on its graph and tilings, both streams);
35. K8 (aux) and K9 in the dropout mode at the main path's shapes (in 18,
    on the same inputs): full outputs against the plain versions, timed in
    turns with the mode without dropout;
36. gat-dropout-training, the twelfth main path (after 20): the GAT of 19
    with the GAT paper's dropout, ``feat_drop`` and ``attn_drop`` 0.6 on
    both layers, 1 + 5 Adam(5e-3) steps, each launching K4, K8 and K9 twice,
    K8 and K9 in the dropout mode; the loss finite and falling; a profile of
    a step; a step with ``attn_drop`` alone peaks within
    ``DROPOUT_PEAK_SLACK`` of the same step without dropout;
37. that GAT with ``attn_drop`` at ``--scale 0.01`` (after 21): logits and
    every gradient against the same layers on the edge-domain route given
    the same hash masks.

38. dist-gcn-training, the thirteenth main path (after 10, the GCN models
    released): ``benchmarking/dist/train.py --dataset ogbn-products`` on
    the port's distribution layer at world size 1 over NCCL, on the graph
    the GCN phases built: ``partition_edges`` at P = 1 (timed), the
    3-layer GCN 100 -> 64 -> 64 -> 47 over ``dist_spmm(impl='kernel')``
    with random weights from ``--seed``, the loss summed over the padded
    rows and divided by their count, Adam(1e-2): 1 warm and 5 timed steps,
    each launching K1's shard mode (``K1_traced``) 3 times and K1 on the
    shard transposes 3 times (the empty frontier launches nothing); the
    first loss against the single-device port's step on the global CSR
    (same weights, f32 stream) to ``DIST_LOSS_TOL``; peak memory; a profile
    of a step; K1's shard mode and K1 on the transpose at F = 64 and 47,
    against their plain versions, timed with ``torch.sparse.mm`` beside;
39. the distributed GCN at ``--scale 0.01`` (after 37): logits and every
    parameter gradient on the kernel route (f32) against the plain route
    in f64;
40. dist-k1-traced-checks (after 32): K1's shard mode against its plain
    version on one shard of a 4-way partition of a 4M-edge power-law check
    graph: the interior CSR, a frontier CSR whose halo table is taller than
    the shard and the local [local | halo] CSR; unweighted and weighted at
    F = 64 and 47, and 4 x 32 weighted with the denominator; K2 on those
    rectangular transposes; the empty frontier of a one-shard partition;
41. dist-halo-2rank (last): two processes on the one card over gloo (the
    exchange staged through the host, as gloo moves no device tensor) on
    ``benchmarking/dist/train.py``'s default synthetic graph (100,000
    nodes, 1,000,000 edges, 64 -> 64 -> 64 -> 16): the training step's loss
    and gradients against the same step at world size 1, the GAT
    attention's kernel route against its plain route at 4 x 32 (values and
    gradients), and each rank's interior and frontier launches and the
    halo rows and bytes it sent. The script starts the ranks as
    ``chip_smoke.py --dist-worker RANK,WORLD,PORT,OUT,BACKEND``.
    With a card for each rank the ranks take NCCL, one card each (the ring
    on device tensors, no staging); ``chip_smoke.py --dist-ranks N`` runs
    only this phase, with N ranks;
42. ogbn-reorder (after 38): ``OgbNodeDataLoader("ogbn-products",
    reorder=True)`` at full size (the label-propagation locality order of
    ``graph/reorder.py``): the reorder's host seconds, ``gather_working_set``
    at 256 B rows on both orders, and K1 forward and on the transpose,
    unweighted, F = 128 with a bf16 stream, on both orders (the work of the
    JAX package's ``bench_ogbn_spmm``), held against its plain version on
    the reordered graph into NaN-poisoned outputs, with ``torch.sparse.mm``
    beside it. The GCN request and step stay on the loader's order, as the
    JAX package's ``bench_ogbn_step`` does.

43. tgcn-epoch (after 26): ``bench.py``'s ``bench_tgcn_epoch`` through
    ``drivers.static_temporal_tgcn``: TGCN(8, 16) and a one-unit head on
    WindmillOutput small at cutoff 100, the MSE over every timestep, one
    backward an epoch; 2 warm and 10 timed epochs on the dense route (no
    kernel launches, checked), a profile of the first
    ``TEMPORAL_PROFILE_STEPS`` timesteps of its own trainer;
44. static-temporal: ``benchmarking/static-temporal-tgcn/train.py
    --feat_size 80 --num_hidden 160`` through ``drivers.static_temporal_tgcn`` on WikiMath (the
    whole sequence, 651 timesteps, the dense route: no kernel; the time of
    the path's ``csr_to_dense`` calls beside the epoch's; 1 warm and 3 timed
    epochs) and on WindmillOutput large at ``--cutoff_time 3000
    --backprop_every 1000 --impl kernel`` (2920 timesteps in 3 windows; 3T
    K1 and 3T K2 an epoch, f32 streams; 1 warm and 1 timed epoch), the MSE
    finite and falling, a profile of the first ``TEMPORAL_PROFILE_STEPS``
    timesteps of the run's own trainer;
45. static-temporal checks: on WindmillOutput large, the warm epoch's first
    window (1000 timesteps of BPTT) on the kernel route against the same
    window on the dense route, and with ``--remat`` (6 K1 and 3 K2 a
    timestep) against it without (loss and gradients), and K1 and K2 with
    the arguments the route gives them at a timestep (f32 streams) against
    their plain versions into poisoned outputs, timed with the library
    calls and their bounds;
46. dynamic-temporal: ``benchmarking/dynamic-temporal-tgcn/train.py --type
    naive|delta|delta-scan`` through ``drivers.dynamic_temporal_tgcn`` on
    England-COVID at ``--feat_size 32 --num_hidden 64`` (dense route) and on
    the wiki-talk-shaped stream at 8 -> 32 (3T K1 and 3T K2 an epoch: the
    lowering weights each edge by its source's norm); 1 warm and 4 timed
    epochs each, the graph side alone
    and a profile of an epoch; the three types' loss trajectories agree to
    ``DYN_TYPES_TOL``; on the stream, K1 and K2 with the arguments the naive
    type's timestep gives them (F = 32, bf16 streams) against their plain
    versions into poisoned outputs, timed as in 45. Phase 26's lazy-scan
    loop runs on ``drivers.dynamic_temporal_tgcn`` too;
47. pma-scan: ``train.py --type pma-scan`` (the PMA store pair, chunks of
    256 slots, one ``apply_delta_pair`` a timestep) on both datasets of 46
    at their widths: 1 warm and 4 timed epochs of 6T K6 and 3T K7, the graph
    side alone, the rebuilds an epoch, a profile (idle share); the hidden
    state at every timestep against delta-scan's from the same parameters
    (``PMA_HIDDEN_TOL``); K6 on pair.fwd and pair.bwd and K7 at the path's
    shapes against their plain versions into poisoned outputs, timed;
48. dist-dyn: ``parallel.dyn`` at the dyn-step shape of 27 (world size 1 on
    NCCL): 64 steps of a replay, ``dist_dyn_spmm`` forward and backward and
    ``dist_dyn_degree`` (one K6 and one K7 a step); the live set against
    the generator's, the output and one more gradient against K6's plain
    version over the whole store;
49. batched-tgcn: ``parallel.batch``'s loss over 4 windows of 8 timesteps
    of WindmillOutput large at 80 -> 160 on a 1 x 1 mesh (NCCL; 3
    K1_traced and 3 K1 a timestep) against the windows run one by one
    through ``dist_tgcn_cell``. The rank phase (41) also runs
    ``parallel.dyn`` at its graph size and the batched loss on (ranks x 1)
    and (1 x ranks) meshes, against world size 1.
50. evolvegcn: ``benchmarking/evolvegcn/train.py --variant o|h --dataset
    wikimath --feat_size 8 --num_hidden 32 --impl kernel`` through
    ``drivers.evolvegcn`` (1068 nodes, 27,079 edges, 723 timesteps): for each
    variant the script's 10 epochs of exactly T K1 and T K2 (f32 streams),
    the loss finite and below the first epoch's at a later one, a profile
    of the first
    ``TEMPORAL_PROFILE_STEPS`` timesteps, those timesteps on the kernel
    route against the dense route (loss, evolved weight, gradients), and K1
    and K2 with a timestep's arguments against their plain versions, timed;
51. segment-sum-edges: ``ops.segment_sum_edges`` on the composed check
    graph at K = 4, 16 (K3) and 24 (K1's no-gather mode), f32 and bf16 with
    NaN in the padding slots: one kernel launch a call (bf16 values also
    take one PyTorch cast to f32 before it) into a poisoned output,
    against the plain versions, f32 out, the backward equal to the gather,
    timed (the cast included);
52. utilities: ``DeviceInfo``, ``device_memory_stats`` against the
    allocator's peak, a ``Timer`` around synced K1 calls, ``profiler.trace``
    of one K1 call in a fresh process holding K1's kernel, ``fetch_float`` of
    EvolveGCN's loss; the run fails if ``d2h_available()`` has latched false.

Every path of the kernels line (serving, training, gat-serving,
gat-training, gat-dropout-training, composed-serving, ppi-serving,
ppi-training, dyn-step, dtdg-training on each dataset, pubmed-rowmask,
rowmask-ppi, dist-gcn-training, tgcn-epoch, static-temporal on each dataset,
dynamic-temporal on each dataset and type, pma-scan on each dataset,
dist-dyn, batched-tgcn and evolvegcn on each variant) is driven with every launch count set to
0 just before it and read just after; K8's and K9's dropout-mode launches
count apart (``K8_dropout``, ``K9_dropout``) as well as with all of theirs,
and K1's shard mode apart from K1 (``K1_traced``).

The last two lines are the kernels JSON and ``{"ok": true, "device": ...}``.
``--details PATH`` also writes every measurement of the run as JSON.

    python3 chip_smoke.py [--scale 1.0] [--seed 0] [--details PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the f32 rate
# outside the tensor cores (K1's adds and multiplies run there).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# Kernel vs plain version: the products are rounded alike (bf16 stream:
# features, weights and products in bf16); the plain version sums in f64,
# the kernel in f32 along at most ~2000 additions (1024 in a warp, then one
# atomicAdd per work item of a split row). The classical bound for that,
# (n - 1) * u * sum|terms| with u = 2^-24, is 1.2e-4 of each output's sum
# of absolute terms; every output element is held to 2e-4 of it.
KERNEL_TOL = 2e-4
# Whole model, kernel path (bf16 stream) vs the plain torch path (f32
# throughout): three roundings of 2^-9 per product, over three layers.
MODEL_TOL = 3e-2
# Gradients, kernel path vs the plain torch path, against the largest
# gradient of each tensor: the backward streams bf16 through three more
# SpMMs (K2 rounds g, fs, w and each product: four roundings of 2^-9) on
# top of the forward's, so six layers of up to four roundings, 24 * 2^-9.
GRAD_TOL = 5e-2
# CUDA vs CPU on the same plain-version arithmetic: the GEMMs and the
# f32 sums run in another order, so a value streamed as bf16 may round to
# the neighbouring bf16 number (2^-8 of it); 1e-2 of the largest value.
DEVICE_TOL = 1e-2

GCN_DIMS = (100, 128, 128, 47)
REQUESTS = 3
SAMPLE_ROWS = 4096
PLAIN_EDGE_BLOCK = 1 << 24  # bounds the plain version's temporaries (~25 GB)
K2_PLAIN_EDGE_BLOCK = 1 << 22  # K2's plain version also gathers fs: ~12 GB
TRAIN_STEPS = 5
CORA_DIMS, CORA_EPOCHS = (1433, 16, 7), 200
GAT_DIMS, GAT_HEADS = (100, 32, 47), (8, 1)  # in, hidden a head, classes; heads a layer
GAT_SLOPE = 0.2
GAT_CHECKS = ((8, 32), (1, 47), (8, 8), (4, 16))  # (H, F) held against the plain versions
GAT_PLAIN_EDGE_BLOCK = 1 << 21  # the plain K8/K9 gather (edges, H*F) planes: ~16 GB
GAT_CHECK_RATES = (0.3, 0.6)  # K8's and K9's dropout mode, held against the plain versions
# The GAT paper's dropout (Velickovic et al. 2018, section 3.3): p = 0.6 on
# the layers' inputs and on the normalised attention coefficients
GAT_FEAT_DROP, GAT_ATTN_DROP = 0.6, 0.6
# Peak device memory of an attention-dropout step over the same step
# without dropout: no (E, H) mask plane (one would be 3.96 GB at 8 heads)
DROPOUT_PEAK_SLACK = 64 << 20
PUBMED_DIMS, PUBMED_HEADS, PUBMED_EPOCHS = (500, 8, 3), (8, 1), 200
# ``benchmarking/gat/train.py --dataset pubmed --cpu`` (the JAX package on
# the CPU, synthetic Pubmed, 200 epochs) reaches train accuracy 0.6322; the
# port must reach it less 0.05 (PERF.md, section 4, Pubmed).
PUBMED_ACC_FLOOR = 0.6322 - 0.05
# bench.py's bench_dyn: the lazy store at the wiki-talk scale
DYN_NODES, DYN_CAP, DYN_SLIDE, DYN_STEPS, DYN_F = 1_100_000, 2_200_000, 10_000, 64, 128
DYN_TCAP = 16 * DYN_SLIDE
ROWID_CHECK_F = (8, 32, 128)
ROWID_PLAIN_EDGE_BLOCK = 1 << 20  # bounds the plain K6's (slots, F) temporaries
# benchmarking/dynamic-temporal-tgcn/train.py's defaults: lags = feat_size 8,
# num_hidden 32, Adam 1e-2; 1 warm epoch and 4 timed ones
DTDG_LAGS, DTDG_HIDDEN, DTDG_LR, DTDG_EPOCHS = 8, 32, 1e-2, 4
DTDG_DATASETS = ("england-covid", "wiki-shape")
# benchmarking/results/dynamic-temporal/README.md's wiki-talk-shaped stream:
# dataset_builder.py --sparse -N 20000 -M 10 -A 0.05 -D 0.05 -T 12
WIKI_SHAPE = dict(num_nodes=20_000, edge_multiplier=10, add_coeff=0.05, delete_coeff=0.05, timestamps=12)
# The temporal drivers (drivers/static_temporal_tgcn.py,
# drivers/dynamic_temporal_tgcn.py). bench.py's bench_tgcn_epoch: TGCN(8, 16)
# on WindmillOutput small at cutoff 100, 2 warm and 10 timed epochs.
TGCN_EPOCH_CUTOFF, TGCN_EPOCH_ITERS, TGCN_EPOCH_WARMUP = 100, 10, 2
# benchmarking/static-bench.sh's widest point (--feat_size 80 --num_hidden
# 160): WikiMath whole sequence on the dense route, and WindmillOutput large
# at --cutoff_time 3000 --backprop_every 1000 --impl kernel; Adam 1e-2; 1 warm
# epoch and timed ones (the script runs 10 and averages epochs >= 3): 3 on
# WikiMath (about 5 s each on the H100's host), 1 on WindmillOutput (about 25
# s each: the host's Python sets an epoch, PERF.md section 5), whose warm
# epoch's windows are also the kernel side of the route checks
STATIC_F, STATIC_H, STATIC_LR = 80, 160, 1e-2
STATIC_RUNS = (("wikimath", None, 0, "auto", 3), ("windmill_large", 3000, 1000, "kernel", 1))  # dataset, cutoff,
# bptt, impl, timed epochs
# The temporal paths' profiles: the first window of this many timesteps of
# the same run (the idle share of a host-bound loop is the same at every
# step; the profiler's own cost grows by about 0.1 s a timestep)
TEMPORAL_PROFILE_STEPS = 32
# Late in a long process the profiler loses the first device events of a
# window (PERF.md section 7): every profile first launches PROFILE_FILLERS
# tiny kernels (waited for, then PROFILE_PAD_S of idle host time) to take
# the loss, and counts the call's own launches that it saw no device event of
PROFILE_FILLERS, PROFILE_PAD_S = 512, 0.1
# the device function that each wrapper count launches, for the check that a
# profile saw every wrapper launch of its call
PROFILED_KERNELS = {"K1": "spmm_rowmask_kernel", "K1_traced": "spmm_rowmask_kernel",
                    "K2": "spmm_sddmm_rowmask_kernel", "K3": "segment_sum_narrow_kernel",
                    "K4": "segment_max_narrow_kernel", "K5": "segment_max_wide_kernel",
                    "K1_nogather": "segment_sum_wide_kernel", "K6": "spmm_rowid_kernel",
                    "K7": "rowid_denom_kernel", "K8": "flash_gat_fwd_kernel", "K9": "flash_gat_bwd_kernel",
                    "K10": "segment_sum_blocked_kernel"}
# benchmarking/dynamic-bench.sh's widest point on England-COVID (--feat_size 32
# --num_hidden 64); the wiki-talk-shaped stream at the script's defaults (8,
# 32: its 12 timestamps leave no window of 32); 1 warm and 4 timed epochs
DYN_TEMPORAL_WIDTHS = {"england-covid": (32, 64), "wiki-shape": (DTDG_LAGS, DTDG_HIDDEN)}
DYN_TEMPORAL_TYPES, DYN_TEMPORAL_EPOCHS = ("naive", "delta", "delta-scan"), 4
# The three dynamic types' loss trajectories (the same negatives): the
# 1e-4 of tests/test_testpack.py
DYN_TYPES_TOL = 1e-4
# The Windmill kernel route (K1, K2: f32 streams, sums in their own order)
# against the dense route (one f32 GEMM a gate), and --remat against none:
# each window's loss to 1e-4 of it, each gradient tensor to 1e-3 of its
# largest element, through up to 1000 timesteps of BPTT
STATIC_LOSS_TOL, STATIC_GRAD_TOL = 1e-4, 1e-3
# The composed GAT route at the GAT paper's PPI widths (Velickovic et al.
# 2018, section 3.3; benchmarking/gat/train.py --num_layers 3 --num_hidden
# 256 --num_heads 4 --num_out_heads 6) on a graph of PPI's size (the paper's
# Table 1) and on the synthetic ogbn-products graph (100 features, 47 classes)
PPI_NODES, PPI_EDGES, PPI_FEATS, PPI_CLASSES = 56_944, 818_716, 50, 121
PPI_HIDDEN, PPI_HEADS = 256, (4, 4, 6)
PPI_DIMS = (PPI_FEATS, PPI_HIDDEN, PPI_CLASSES)
OGBN_FEATS, OGBN_CLASSES = 100, 47
K3_CHECK_K = (1, 4, 6, 16)
COMPOSED_CHECKS = ((4, 256), (6, 121), (3, 20), (3, 7), (40, 4))  # (H, F) of K10's checks
COMPOSED_SAMPLE_ROWS = 1024
COMPOSED_PLAIN_EDGE_BLOCK = 1 << 18  # bounds the plain K10's (slots, H*F) temporaries (~5 GB)
# The composed route (f32, its kernels' atomics in run-dependent order) vs
# the vertex program with K3's and K4's plain versions (f32, f64 sums):
# logits to 1e-4 of the largest, one step's gradients to 1e-3 of each
# tensor's largest
COMPOSED_LOGIT_TOL = 1e-4
COMPOSED_GRAD_TOL = 1e-3
# The composed route's rowmask branch (benchmarking/gat/train.py --dataset
# pubmed --num_heads 32 --num_hidden 4: 500 -> 32 x 4 with ELU -> 1 x 3,
# Adam 5e-3, 200 epochs). The JAX script with ``--cpu`` (the JAX package on
# the CPU, synthetic Pubmed, the dataset loader held offline) reaches train
# accuracy 0.5781; the port must reach it less 0.05 (PERF.md, section 4).
PUBMED_ROWMASK_DIMS, PUBMED_ROWMASK_HEADS = (500, 4, 3), (32, 1)
PUBMED_ROWMASK_ACC_FLOOR = 0.5781 - 0.05
WIDE_CHECK_K = (17, 32, 130)  # K5's and the no-gather sum's widths held against their plain versions
ROWMASK_CHECKS = ((32, 4), (8, 64), (4, 128), (64, 2), (1, 384))  # (H, F) of K1's and K2's heads modes
ROWMASK_PPI_TILING = (32, 4)
# K2's heads mode in phase_k2_vs_plain at the rowmask route's tiling (ROWMASK_CHECKS holds the others),
# and items of K2_CHECK_ITEMS (H, F, edges): hub rows split across items that end inside a step
K2_HEADS_CHECKS = ((32, 4),)
K2_CHECK_ITEMS = ((1, 47, 37), (1, 47, 128), (32, 4, 37))
K4_CHECK_CHUNK = 37  # K4's checks also at items of this many edges
# The rowmask route with a bf16 stream (the PPI-sized graph: 818,716 edges)
# against an f64 recomputation of the same softmax attention, each output
# element against its sum of absolute terms (for ``out``, the
# softmax-weighted |feat| rows; for ``d feat``, the weighted |g| rows; for
# ``d el`` and ``d er``, sum_e alpha_e (sum_f |feat_f g_f| + sum_f |g_f|
# out-mass_f[dst]) |leaky'|, since the route forms c = <g, out> / den from
# its own bf16-streamed output, whose error is relative to out's mass, not
# to |out|). A bf16 rounding errs by at most 2^-8 of its value. A term of
# ``out`` and of ``d feat`` is rounded three times (the weight, the feature
# or cotangent, their product: K1 and K2 in bf16); a term of ``d el`` and
# ``d er`` four times (K2's three in the per-head dot, then the no-gather
# sum rounds each ds0 to bf16). The f32 work around them (scores, maxima,
# exp, the denominator, every sum) adds at most KERNEL_TOL.
ROWMASK_OUT_TOL = (1 + 2**-8) ** 3 - 1 + KERNEL_TOL
ROWMASK_SCORE_TOL = (1 + 2**-8) ** 4 - 1 + KERNEL_TOL
# Hidden states, lazy pair (K6, f32 sums in one order) vs NaiveGraph
# snapshots (K1, another order), over up to 53 timesteps of three gates
HIDDEN_TOL = 1e-3
# One epoch's parameter gradients, lazy pair vs NaiveGraph snapshots, each
# tensor against its largest element: the same f32 arithmetic as the hidden
# states, carried back through every timestep
DTDG_GRAD_TOL = 1e-3


# The PMA store (train.py --type pma-scan) at the dynamic-temporal phase's
# widths: its hidden states against delta-scan's at every timestep, the
# same parameters and graph sequence, f32 on both routes (K6 and the dense
# route or K1 sum in their own orders)
PMA_HIDDEN_TOL = 1e-5


# The distribution layer (benchmarking/dist/train.py --dataset ogbn-products:
# 100 -> 64 -> 64 -> 47, --layers 3, Adam 1e-2), at world size 1 on NCCL
DIST_DIMS, DIST_LR = (100, 64, 64, 47), 1e-2
# benchmarking/dist/train.py's default synthetic graph (--nodes 100000 --edges
# 1000000 --feat 64 --hidden 64 --layers 3, 16 classes, power-law sources)
DIST_SMALL = dict(nodes=100_000, edges=1_000_000, feat=64, hidden=64, layers=3, classes=16)
DIST_RANKS = 2  # two processes: gloo on one card, or NCCL on a card each
DIST_GAT_TILING = (4, 32)
DIST_CHECK_SHARDS = 4  # the K1 shard-mode checks' partition
DIST_WORKER_TIMEOUT = 600
# The distributed loss at world size 1 against the single-device step on
# the global CSR: the same K1 in f32 over the same edge order (the shard
# CSR at P = 1 is the global one), so only the atomics of split hub rows
# may reorder a sum: 1e-5 of the loss
DIST_LOSS_TOL = 1e-5
# Two ranks against one, and the kernel route against the plain route: f32
# throughout, only the order of the f32 sums differs; each tensor to 1e-4 of
# its largest element
DIST_TOL = 1e-4
# parallel.dyn: bench.py's bench_dyn at the dyn-step shape (DYN_*, world
# size 1 on NCCL), and at the dist-halo-2rank phase's graph size (two ranks
# against one)
DIST_DYN_SMALL = dict(nodes=100_000, edges=1_000_000, slide=10_000, steps=8, feat=64)
# parallel.batch: WindmillOutput large at the static-temporal phase's widest
# point (STATIC_F -> STATIC_H), BATCH_WINDOWS windows of BATCH_STEPS
# timesteps; the 2-D meshes of the rank phase are (ranks x 1) and (1 x ranks)
BATCH_WINDOWS, BATCH_STEPS = 4, 8
# benchmarking/evolvegcn/train.py's defaults (--feat_size 8 --num_hidden 32,
# Adam 1e-2, 10 epochs, the time averaged over epochs >= 3) on WikiMath,
# --impl kernel, each variant
EVOLVE_F, EVOLVE_H, EVOLVE_LR, EVOLVE_EPOCHS = 8, 32, 1e-2, 10
SEGMENT_SUM_EDGES_K = (4, 16, 24)  # K3's, K3's widest and the no-gather sum's


class SmokeFailure(Exception):
    pass


PHASE_SECONDS = []  # (phase, wall seconds) of each phase call of this run, in order


def timed_phase(fn):
    """Append the wall time of every call of the phase ``fn`` to
    ``PHASE_SECONDS`` (the details' ``phase_s``: where the script's own
    time goes)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        t = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            PHASE_SECONDS.append((fn.__name__, time.perf_counter() - t))

    return run


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _counters():
    """Each count's wrapper and attribute: ``launches`` counts every launch
    of a kernel; K8's and K9's ``dropout_launches`` those of them in the
    dropout mode."""
    from stgraph_tpu_torch.ops import flash_gat, rowid_kernels, segment_kernels, spmm_blocked, spmm_kernels

    fns = {"K1": spmm_kernels.spmm_rowmask, "K2": spmm_kernels.spmm_rowmask_bwd,
           "K3": segment_kernels.segment_sum_narrow, "K4": segment_kernels.segment_max_narrow,
           "K5": segment_kernels.segment_max_wide, "K1_nogather": segment_kernels.segment_sum_wide,
           "K6": rowid_kernels.spmm_rowid, "K7": rowid_kernels.dyn_degree, "K8": flash_gat.flash_gat_fwd,
           "K9": flash_gat.flash_gat_bwd, "K10": spmm_blocked.segment_sum_blocked}
    fns["K1_traced"] = spmm_kernels.spmm_rowmask_traced
    counts = {k: (fn, "launches") for k, fn in fns.items()}
    counts["K8_dropout"] = (flash_gat.flash_gat_fwd, "dropout_launches")
    counts["K9_dropout"] = (flash_gat.flash_gat_bwd, "dropout_launches")
    return counts


def only(**launched) -> dict:
    """The launch counts of a path that launched ``launched`` and nothing else."""
    return {k: launched.get(k, 0) for k in _counters()}


def reset_counts() -> None:
    """Every kernel wrapper's launch counts to 0."""
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def k1_bound(n: int, e: int, f: int, weighted: bool):
    """Least time for one K1 call: indptr, cols, w and the f32 feature table
    read once, the f32 output written once, over HBM; or 2 (1 unweighted)
    f32 operations per edge and column over the f32 peak."""
    nbytes = (n + 1) * 4 + e * 4 + (e * 4 if weighted else 0) + n * f * 4 + n * f * 4
    ops = (2 if weighted else 1) * e * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k2_bound(n: int, e: int, f: int):
    """Least time for one K2 call: indptr, cols, w and dw once each, the f32
    g and fs tables read once, the f32 dh written once, over HBM; or 4 f32
    operations per edge and column over the f32 peak."""
    nbytes = (n + 1) * 4 + 3 * e * 4 + 3 * n * f * 4
    ops = 4 * e * f
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _err_over_mass(err, mass):
    return (err / mass.clamp(min=1e-30)).masked_fill(err == 0, 0.0).max().item()


def poisoned_call(shape, fn):
    """``fn()`` after a block of ``shape`` f32 was filled with NaN and freed:
    the caching allocator hands that block to the kernel's output, so a row
    the kernel failed to write shows as NaN. Fails unless the output took
    the block and holds no NaN; returns the output."""
    torch.cuda.empty_cache()
    t = torch.full(shape, float("nan"), dtype=torch.float32, device="cuda")
    ptr = t.data_ptr()
    del t
    out = fn()
    res = out[0] if isinstance(out, tuple) else out
    check(res.data_ptr() == ptr, f"the poisoned block of {shape} went elsewhere: the check would be vacuous")
    check(not bool(res.isnan().any().item()), f"the kernel left output rows of {shape} unwritten (NaN)")
    return out


def poisoned_k2_call(shape_dh, shape_dw, fn):
    """K2's ``fn()`` with its dh and dw filled with NaN before the kernel
    runs: the wrapper's ``torch.empty`` of those two shapes returns NaN (two
    outputs, so the freed-block trick of ``poisoned_call`` cannot place both
    by the caching allocator's best fit). Fails unless both outputs were
    poisoned and hold no NaN after the kernel. Returns (dh, dw)."""
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    real, poisoned = SK.torch, []

    class _PoisoningTorch:  # the wrapper's torch: empty() of the outputs' shapes filled with NaN
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def empty(*size, **kw):
            t = real.empty(*size, **kw)
            if t.dtype == real.float32 and tuple(t.shape) in (tuple(shape_dh), tuple(shape_dw)):
                poisoned.append(tuple(t.shape))
                t.fill_(float("nan"))
            return t

    SK.torch = _PoisoningTorch()
    try:
        dh, dw = fn()
    finally:
        SK.torch = real
    check(sorted(poisoned) == sorted([tuple(shape_dh), tuple(shape_dw)]),
          f"K2's outputs of {shape_dh} and {shape_dw} were not both poisoned ({poisoned}): the check would be vacuous")
    check(not bool(dh.isnan().any().item()) and not bool(dw.isnan().any().item()),
          f"K2 left elements of dh {shape_dh} or dw {shape_dw} unwritten (NaN)")
    return dh, dw


def k1_agreement(out, csr, w, x, stream, edge_block=None):
    """Hold K1's output against its plain version on the same inputs.
    Returns (max_abs_err, worst err / sum|terms| ratio, max |plain|)."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_plain

    ref = spmm_rowmask_plain(csr, w, x, stream, edge_block)
    err = (out - ref).abs()
    max_err, max_ref = err.max().item(), ref.abs().max().item()
    del ref
    absw = None if w is None else w.abs()
    mass = spmm_rowmask_plain(csr, absw, x.abs(), stream, edge_block)  # sum of |terms|
    ratio = _err_over_mass(err, mass)
    return max_err, ratio, max_ref


def k2_agreement(dh, dw, csr_t, w, g, fs, stream, edge_block=None):
    """Hold K2's ``dh`` and ``dw`` against its plain version on the same
    inputs. Returns per output (max_abs_err, worst err / sum|terms|, max
    |plain|), and whether every padding slot of ``dw`` is exactly 0."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd_plain

    refs = spmm_rowmask_bwd_plain(csr_t, w, g, fs, stream, edge_block)
    errs = [(out - ref).abs() for out, ref in zip((dh, dw), refs)]
    max_refs = [ref.abs().max().item() for ref in refs]
    del refs
    masses = spmm_rowmask_bwd_plain(csr_t, w.abs(), g.abs(), fs.abs(), stream, edge_block)
    stats = [(err.max().item(), _err_over_mass(err, mass), m)
             for err, mass, m in zip(errs, masses, max_refs)]
    return stats[0], stats[1], not dw[csr_t.num_edges:].any().item()


@timed_phase
def phase_environment(port):
    from stgraph_tpu_torch import native
    from stgraph_tpu_torch.ops import kernel_lib

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [kernel_lib._nvcc(), "--version"], capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    logs = kernel_lib.build()
    check(native.available(), "the native CSR builder did not build")
    build_s = time.perf_counter() - t0
    print(f"env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, nvcc: {nvcc}")
    print(smi)
    print(f"build: kernels {sorted(kernel_lib.SOURCES)} + native CSR builder in {build_s:.2f} s")
    ptxas = {}
    for name, log in logs.items():
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", log)]
        ptxas[name] = {"kernels": len(regs), "max_registers": max(regs, default=0),
                       "spilling": sum(b > 0 for b in spills), "max_spill_stores": max(spills, default=0),
                       "log": log}
        print(f"  ptxas[{name}]: {len(regs)} kernels, registers {min(regs, default=0)}-{max(regs, default=0)}, "
              f"{ptxas[name]['spilling']} with spill stores (at most {ptxas[name]['max_spill_stores']} B)")
    return {"nvidia_smi": smi, "nvcc": nvcc, "build_s": build_s, "ptxas": ptxas}


@timed_phase
def phase_k1_vs_plain(dev, rng):
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask

    n, e, empty, hub, hub_deg = 200_000, 4_000_000, 1000, 12_345, 300_000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n - empty, e)
    dst[:hub_deg] = hub
    csr = build_csr(src, dst, n, device=dev)
    results, worst = [], 0.0
    for f in (47, 100, 128):
        x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.random(csr.capacity).astype(np.float32)).to(dev)
        for weighted in (False, True):
            for stream in (torch.float32, torch.bfloat16):
                ww = w if weighted else None
                out, _ = poisoned_call((n, f), lambda: spmm_rowmask(csr, ww, x, stream_dtype=stream))
                torch.cuda.synchronize()
                err, ratio, max_ref = k1_agreement(out, csr, ww, x, stream)
                ok = ratio <= KERNEL_TOL and not out[n - empty:].any().item()
                tag = f"F={f} {'weighted' if weighted else 'unweighted'} {str(stream)[6:]} stream"
                print(f"k1-check {tag}: max_abs_err {err:.3e} (max |plain| {max_ref:.1f}), "
                      f"worst err/sum|terms| {ratio:.2e} (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"K1 disagrees with its plain version at {tag}")
                worst = max(worst, err)
                results.append({"case": tag, "max_abs_err": err, "err_over_mass": ratio,
                                "max_abs_plain": max_ref})
    return {"graph": {"n": n, "e": e, "empty_rows": empty, "hub_deg": hub_deg},
            "cases": results, "max_abs_err": worst}


@timed_phase
def phase_k2_vs_plain(dev, rng, n=200_000, e=4_000_000, hub_deg=300_000):
    """K2 against its plain version on the transpose of a 4M-edge graph with
    1000 empty rows and a 300k-edge hub in each direction, into NaN-poisoned
    dh and dw (``poisoned_k2_call``): one head at F in {7, 16, 47, 100, 128,
    130} and the heads mode at (H, F) in ``K2_HEADS_CHECKS``, f32 and bf16
    streams, at the port's item lengths (``K2_CHUNK``) and at the short items
    of ``K2_CHECK_ITEMS`` (items ending inside a lane group's step)."""
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    empty, hub = 1000, 12_345
    src = rng.integers(0, n - empty, e)  # the transpose's rows: 1000 empty
    dst = rng.integers(0, n - empty, e)
    dst[:hub_deg] = hub
    src[-hub_deg:] = hub + 1  # a hub row of the transpose too
    csr_t = build_csr(src, dst, n, device=dev).transpose()
    results, worst = [], 0.0
    cases = [(1, f, None) for f in (7, 16, 47, 100, 128, 130)]
    cases += [(h, f, None) for h, f in K2_HEADS_CHECKS]
    cases += list(K2_CHECK_ITEMS)
    saved = dict(SK.K2_CHUNK)
    try:
        for h, f, chunk in cases:
            if chunk is not None:
                SK.K2_CHUNK.update(one_head=chunk, heads=chunk)
            g = torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(dev)
            fs = torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(dev)
            w = torch.from_numpy(rng.standard_normal((csr_t.capacity, h)).astype(np.float32)).to(dev)
            for stream in (torch.float32, torch.bfloat16):
                dh, dw = poisoned_k2_call((n, h * f), (csr_t.capacity, h), lambda: SK.spmm_rowmask_bwd(
                    csr_t, w, g, fs, stream_dtype=stream, heads=h))
                torch.cuda.synchronize()
                if h == 1:
                    (dh_err, dh_ratio, dh_ref), (dw_err, dw_ratio, dw_ref), pad_zero = k2_agreement(
                        dh, dw, csr_t, w.reshape(-1), g, fs, stream)
                else:
                    refs = SK.spmm_rowmask_bwd_plain(csr_t, w, g, fs, stream, COMPOSED_PLAIN_EDGE_BLOCK, heads=h)
                    masses = SK.spmm_rowmask_bwd_plain(csr_t, w.abs(), g.abs(), fs.abs(), stream,
                                                       COMPOSED_PLAIN_EDGE_BLOCK, heads=h)
                    (dh_err, dh_ratio, dh_ref), (dw_err, dw_ratio, dw_ref) = _stats([dh, dw], refs, masses)
                    pad_zero = not dw[csr_t.num_edges:].any().item()
                    del refs, masses
                ok = (dh_ratio <= KERNEL_TOL and dw_ratio <= KERNEL_TOL and pad_zero
                      and not dh[n - empty:].any().item())
                tag = (f"H={h} F={f} {str(stream)[6:]} stream, items of "
                       f"{chunk or SK.K2_CHUNK['heads' if h > 1 else 'one_head']} edges")
                print(f"k2-check {tag}: dh max_abs_err {dh_err:.3e} (max |plain| {dh_ref:.1f}, "
                      f"err/sum|terms| {dh_ratio:.2e}); dw max_abs_err {dw_err:.3e} (max |plain| "
                      f"{dw_ref:.1f}, err/sum|terms| {dw_ratio:.2e}); padding dw zero {pad_zero}; poisoned "
                      f"outputs (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"K2 disagrees with its plain version at {tag}")
                worst = max(worst, dh_err, dw_err)
                results.append({"case": tag, "H": h, "F": f, "chunk": chunk, "dh_max_abs_err": dh_err,
                                "dh_err_over_mass": dh_ratio, "dw_max_abs_err": dw_err, "dw_err_over_mass": dw_ratio})
                del dh, dw
            del g, fs, w
            SK.K2_CHUNK.update(saved)
    finally:
        SK.K2_CHUNK.update(saved)
    return {"graph": {"n": n, "e": e, "empty_rows": empty, "hub_deg": hub_deg},
            "cases": results, "max_abs_err": worst}


class GCN(torch.nn.Module):
    """The served model: GCNConv layers over a fixed graph."""

    def __init__(self, graph, dims, impl, device):
        super().__init__()
        from stgraph_tpu_torch.nn import GCNConv

        self.graph = graph
        self.layers = torch.nn.ModuleList(
            GCNConv(a, b, activation=None if i == len(dims) - 2 else torch.relu, impl=impl, device=device)
            for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))
        )

    def forward(self, h):
        for layer in self.layers:
            h = layer(self.graph, h)
        return h


def numpy_gcn_params(dims, seed):
    """A flax-shaped GCN parameter tree (xavier-uniform weights, zero bias)
    made with numpy from ``seed``, as the JAX package would hand it over."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lim = np.sqrt(6.0 / (a + b))
        tree[f"GCNConv_{i}"] = {
            "weight": rng.uniform(-lim, lim, (a, b)).astype(np.float32),
            "bias": np.zeros(b, np.float32),
        }
    return {"params": tree}


def build_model(graph, impl, dev, seed, dims=GCN_DIMS):
    from stgraph_tpu_torch.convert import gcn_params_from_jax

    model = GCN(graph, dims, impl, dev)
    model.load_state_dict(gcn_params_from_jax(numpy_gcn_params(dims, seed)))
    return model.eval()


def sampled_layer_check(graph, layer, h_in, y, rows, relu):
    """Hold one layer's served output against the plain formula
    ``act(norm_d * sum_e bf16(bf16(hw[c]) * bf16(norm[c])) + b)`` on ``rows``,
    summed in f64. Returns (max_abs_err, worst err / (norm_d sum|terms|),
    max |ref|, edges checked)."""
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    csr = graph.fwd_csr
    indptr = csr.host_arrays()[0].astype(np.int64)
    deg = indptr[rows + 1] - indptr[rows]
    local = np.repeat(np.arange(len(rows)), deg)
    first = np.cumsum(deg) - deg
    eidx = indptr[rows][local] + (np.arange(deg.sum()) - first[local])
    dev = y.device
    cols = csr.cols[torch.from_numpy(eidx).to(dev)].long()
    norm = symmetric_norm(graph)
    hw = h_in @ layer.weight
    prod = hw[cols].to(torch.bfloat16).float() * norm[cols].to(torch.bfloat16).float()
    prod = prod.to(torch.bfloat16).double()
    local_t = torch.from_numpy(local).to(dev)
    zeros = torch.zeros(len(rows), hw.shape[1], dtype=torch.float64, device=dev)
    agg = zeros.index_add(0, local_t, prod)
    mass = zeros.index_add(0, local_t, prod.abs())
    norm_d = norm[torch.from_numpy(rows).to(dev)].double()
    ref = agg * norm_d + layer.bias.double()
    if relu:
        ref = torch.relu(ref)
    got = y[torch.from_numpy(rows).to(dev)].double()
    err = (got - ref).abs()
    ratio = (err / (mass * norm_d).clamp(min=1e-300)).masked_fill(err == 0, 0.0).max().item()
    return err.max().item(), ratio, ref.abs().max().item(), int(deg.sum())


@timed_phase
def phase_serving(dev, args, workdir):
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd
    from stgraph_tpu_torch.serve import Predictor

    t0 = time.perf_counter()
    data = OgbNodeDataLoader(root=workdir, scale=args.scale, seed=args.seed)
    n = data.gdata["num_nodes"]
    t1 = time.perf_counter()
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    feats = torch.from_numpy(data.get_all_features()).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model = build_model(graph, "auto", dev, args.seed)
    predictor = Predictor.build(model, dict(model.state_dict()), (feats,), device=dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    e = graph.get_num_edges()
    print(f"serve setup: synthetic={data.synthetic} N={n} E={e}: data {t1 - t0:.2f} s, "
          f"graph build+upload {t2 - t1:.2f} s, model+Predictor.build (warm call) {t3 - t2:.2f} s")

    captured = []
    hooks = [
        layer.register_forward_hook(lambda mod, inp, out: captured.append((inp[1], out)))
        for layer in model.layers
    ]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    requests = [feats] + [
        feats + 0.1 * torch.randn(feats.shape, device=dev, generator=gen) for _ in range(REQUESTS - 1)
    ]
    torch.cuda.synchronize()
    times = []
    reset_counts()
    for r, x in enumerate(requests):
        before = spmm_rowmask.launches
        t = time.perf_counter()
        logits = predictor(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if r == 0:
            for h in hooks:
                h.remove()
        check(spmm_rowmask.launches - before == 3,
              f"request {r}: K1 launched {spmm_rowmask.launches - before} times, expected 3")
        check(tuple(logits.shape) == (n, GCN_DIMS[-1]), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all().item()), f"request {r}: non-finite logits")
    counts = read_counts()
    launches = counts["K1"]
    check(counts == only(K1=3 * REQUESTS),
          f"serving launched {counts}, expected K1 only")
    print(f"serve: {REQUESTS} requests, K1 launches {launches}, K2 launches 0, per-request s "
          f"{[round(t, 4) for t in times]}, logits finite, shape {tuple(logits.shape)}")

    rng = np.random.default_rng(args.seed + 1)
    deg = graph.in_degrees()
    rows = np.unique(np.concatenate([rng.choice(n, min(SAMPLE_ROWS, n), replace=False), [int(deg.argmax())]]))
    checks = []
    with torch.inference_mode():
        for i, (layer, (h_in, y)) in enumerate(zip(model.layers, captured)):
            err, ratio, max_ref, n_edges = sampled_layer_check(graph, layer, h_in, y, rows, relu=i < 2)
            # the f32 bias add and ReLU add one rounding of the output: u = 6e-8 of |ref|
            ok = ratio <= KERNEL_TOL or err <= 1e-6 * max(1.0, max_ref)
            print(f"serve-check layer {i} (F={layer.out_feats}): {len(rows)} rows incl. hub of "
                  f"degree {int(deg.max())}, {n_edges} edges: max_abs_err {err:.3e} (max |ref| "
                  f"{max_ref:.2f}), worst err/(norm*sum|terms|) {ratio:.2e} {'ok' if ok else 'FAIL'}")
            check(ok, f"layer {i} output disagrees with the plain formula")
            checks.append({"layer": i, "max_abs_err": err, "err_over_mass": ratio,
                           "max_abs_ref": max_ref, "rows": len(rows)})
    return {
        "graph": graph, "model": model, "predictor": predictor, "feats": feats,
        "labels": torch.from_numpy(data.get_all_targets()).to(dev),
        "inputs": [h for h, _ in captured], "launches": launches, "counts": counts,
        "record": {
            "n": n, "e": e, "synthetic": data.synthetic, "scale": args.scale,
            "data_s": t1 - t0, "graph_s": t2 - t1, "build_s": t3 - t2,
            "request_s": times, "launches": launches, "sampled_checks": checks,
            "max_in_degree": int(deg.max()),
        },
    }


@timed_phase
def phase_k1_at_main_shapes(served):
    from stgraph_tpu_torch.ops import message as M
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_plain
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    graph = served["graph"]
    csr = graph.fwd_csr
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    per_launch, worst = [], 0.0
    with torch.inference_mode():
        w = M.gather_src(csr, symmetric_norm(graph))  # the lowering's weight
        lib_a = torch.sparse_csr_tensor(csr.indptr, csr.cols[:e], w.reshape(-1)[:e], size=(n, n),
                                        check_invariants=False)
        for layer, h_in in zip(served["model"].layers, served["inputs"]):
            hw = h_in @ layer.weight
            f = hw.shape[1]
            bf16 = torch.bfloat16
            out, _ = poisoned_call((n, f), lambda: spmm_rowmask(csr, w, hw, stream_dtype=bf16))
            torch.cuda.synchronize()
            err, ratio, max_ref = k1_agreement(out, csr, w, hw, bf16, PLAIN_EDGE_BLOCK)
            check(ratio <= KERNEL_TOL, f"K1 at F={f} (full graph) disagrees: err/sum|terms| {ratio}")
            del out
            ms = cuda_ms(lambda: spmm_rowmask(csr, w, hw, stream_dtype=bf16), iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: spmm_rowmask_plain(csr, w, hw, bf16, edge_block=PLAIN_EDGE_BLOCK),
                               iters=2, warmup=1)
            try:  # a timed yardstick only; the port never calls it
                lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, hw), iters=5, warmup=1)
            except RuntimeError as exc:
                print(f"library yardstick unavailable at F={f}: {exc}")
                lib_ms = None
            bound_ms, bound_by, nbytes, ops = k1_bound(n, e, f, weighted=True)
            print(f"k1-main F={f}: {ms:.3f} ms (plain {plain_ms:.1f} ms, torch.sparse.mm {lib_ms} ms, "
                  f"bound {bound_ms:.3f} ms by {bound_by}); full-graph max_abs_err {err:.3e} "
                  f"(max |plain| {max_ref:.2f}), worst err/sum|terms| {ratio:.2e}")
            worst = max(worst, err)
            per_launch.append({"F": f, "E": e, "N": n, "stream": "bf16", "weighted": True,
                               "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                               "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
                               "ops": ops, "max_abs_err": err, "err_over_mass": ratio})
    return per_launch, worst


@timed_phase
def phase_model_vs_plain(dev, args, workdir):
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    x = torch.from_numpy(data.get_all_features()).to(dev)
    with torch.inference_mode():
        out_k = build_model(graph, "auto", dev, args.seed)(x)
        out_p = build_model(graph, "torch", dev, args.seed)(x)
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    ok = err <= MODEL_TOL * scale
    print(f"model-check scale 0.01 (N={n}, E={graph.get_num_edges()}): kernel path vs plain torch "
          f"path max_abs_err {err:.3e} (max |plain| {scale:.3f}, tol {MODEL_TOL:g} x that) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "the served model disagrees with the plain path at scale 0.01")
    return {"n": n, "e": graph.get_num_edges(), "max_abs_err": err, "max_abs_plain": scale}


FILL_RANGE = "chip_smoke.profile_fill"


def profile_fill():
    """``PROFILE_FILLERS`` one-element adds on the card, waited for, inside
    a ``record_function`` range: the first device events of a profiler
    window, which the profiler may lose late in a process."""
    from torch.profiler import record_function

    t = torch.zeros(1, device="cuda")
    with record_function(FILL_RANGE):
        for _ in range(PROFILE_FILLERS):
            t.add_(1)
        torch.cuda.synchronize()
    time.sleep(PROFILE_PAD_S)


def profiled(fn):
    """One call of ``fn`` under ``torch.profiler`` (CPU and CUDA activities),
    after ``profile_fill``. Returns the call's device events as (name, start
    ns, end ns), a record of the launches (kernels, copies, fills) that the
    host issued in the fill and in the call and how many of each have no
    device event in the profile (their correlation ids; the host's calls
    after the fill's end and a half pad are the call's), the least lag from
    one of the call's launches to its start on the device, and the call's
    host ms. The events are read from the profiler's raw results (the ones
    ``prof.events()`` keeps), without building its tree of host events
    (seconds for a few thousand host operations)."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profile_fill()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = list(prof.profiler.kineto_results.events())
    fill_end = max(e.end_ns() for e in events if e.name() == FILL_RANGE)
    split = fill_end + int(PROFILE_PAD_S * 5e8)
    issued = {"fill": {}, "call": {}}
    device = []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not _filter_name(e.name()) and not getattr(e, "is_hidden_event", lambda: False)():
                device.append(e)
        elif any(k in e.name() for k in ("LaunchKernel", "Memcpy", "Memset")):
            issued["call" if e.start_ns() > split else "fill"][e.correlation_id()] = e.start_ns()
    seen = {e.correlation_id() for e in device}
    own = [e for e in device if e.correlation_id() in issued["call"]]
    lags = [e.start_ns() - issued["call"][e.correlation_id()] for e in own]
    launches = {"issued": len(issued["call"]), "missing": len(set(issued["call"]) - seen),
                "fill_issued": len(issued["fill"]), "fill_missing": len(set(issued["fill"]) - seen)}
    return ([(e.name(), e.start_ns(), e.end_ns()) for e in own], launches,
            min(lags) / 1e6 if lags else None, wall_ms)


def profile_short(kernels, launched) -> dict:
    """The wrapper kernels that a profile saw fewer times than their
    wrappers launched them in its call: {device function: [seen,
    launched]} (empty: the profile is complete for them)."""
    want = {}
    for key, n in launched.items():
        if n and key in PROFILED_KERNELS:
            want[PROFILED_KERNELS[key]] = want.get(PROFILED_KERNELS[key], 0) + n
    seen = {fn: sum(1 for name, _, _ in kernels if fn in name) for fn in want}
    return {fn: [seen[fn], n] for fn, n in want.items() if seen[fn] < n}


@timed_phase
def phase_profile(fn, what):
    """Device time by kernel over one call of ``fn`` (``profiled``), and the
    device's idle share between its first and last kernel. A profile that
    saw no device event of some launch of the call, or fewer kernels of a
    wrapper than the wrapper's count of the call, is marked short: its
    device figures are then a lower bound."""
    fn()  # the profiler's own first-use cost stays out of the window
    torch.cuda.synchronize()
    before = read_counts()
    kernels, launches, lag_ms, wall_ms = profiled(fn)
    launched = {k: v - before[k] for k, v in read_counts().items() if v - before[k]}
    check(len(kernels) > 0, "the profiler saw no device activity")
    short = profile_short(kernels, launched)
    complete = not short and not launches["missing"]
    by_name = {}
    for name, start, end in kernels:
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (end - start) / 1e6, count + 1)
    busy = sum(ms for ms, _ in by_name.values())
    span = (max(end for _, _, end in kernels) - min(start for _, start, _ in kernels)) / 1e6
    rows = sorted(((ms, name, c) for name, (ms, c) in by_name.items()), reverse=True)
    seen = (f"device events of {launches['issued'] - launches['missing']} of its {launches['issued']} launches, "
            f"wrapper kernels {'all seen' if not short else f'short {short}'} ({launched}); "
            f"the fill's {launches['fill_missing']} of {launches['fill_issued']} lost")
    print(f"profile: {what} {wall_ms:.1f} ms wall (profiled); kernels busy {busy:.2f} ms of a "
          f"{span:.2f} ms device span (idle share {1 - busy / span:.3f}); {seen}; least launch-to-start lag "
          f"{'not measured' if lag_ms is None else f'{lag_ms:.4f} ms'}"
          f"{'' if complete else '; SHORT: its device figures are a lower bound'}")
    for ms, name, count in rows[:8]:
        print(f"  {ms:9.3f} ms  x{count:<3d} {name[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_span_ms": span,
            "idle_share": 1 - busy / span, "launches": launches, "wrapper_launches": launched, "short": short,
            "complete": complete, "min_launch_lag_ms": lag_ms,
            "top": [{"ms": ms, "name": name, "count": c} for ms, name, c in rows[:12]]}


@timed_phase
def phase_k2_at_main_shapes(served):
    """K2 on the transpose of the full graph at the widths a training step
    gives it (F = 128 and 47), with the forward's own weights and features
    (``fs``) and a random cotangent."""
    from stgraph_tpu_torch.ops import message as M
    from stgraph_tpu_torch.ops.spmm_kernels import K2_CHUNK, spmm_rowmask_bwd, spmm_rowmask_bwd_plain
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    graph = served["graph"]
    csr = graph.fwd_csr
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    t0 = time.perf_counter()
    csr_t = csr.transpose()
    t1 = time.perf_counter()
    perm_t, _, _ = csr.edge_perms()
    t2 = time.perf_counter()
    max_out = int(np.diff(csr_t.host_arrays()[0]).max())
    print(f"k2-main setup: transpose CSR (host counting sort + upload) {t1 - t0:.2f} s, "
          f"edge permutations {t2 - t1:.2f} s, largest out-degree {max_out}")
    per_launch, worst = [], 0.0
    gen = torch.Generator(device=csr.device).manual_seed(7)
    bf16 = torch.bfloat16
    with torch.inference_mode():
        w = M.gather_src(csr, symmetric_norm(graph)).reshape(-1)
        w_t = w.index_select(0, perm_t)
        pattern = torch.sparse_csr_tensor(csr_t.indptr, csr_t.cols[:e], w_t[:e], size=(n, n),
                                          check_invariants=False)
        for layer, h_in in (pair for i, pair in enumerate(zip(served["model"].layers, served["inputs"]))
                            if i in (1, 2)):
            fs = h_in @ layer.weight
            f = fs.shape[1]
            g = torch.randn(fs.shape, device=fs.device, generator=gen)
            dh, dw = spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=bf16)
            torch.cuda.synchronize()
            (dh_err, dh_ratio, _), (dw_err, dw_ratio, _), pad_zero = k2_agreement(
                dh, dw, csr_t, w_t, g, fs, bf16, K2_PLAIN_EDGE_BLOCK)
            check(dh_ratio <= KERNEL_TOL and dw_ratio <= KERNEL_TOL and pad_zero,
                  f"K2 at F={f} (full graph) disagrees: dh {dh_ratio}, dw {dw_ratio}, padding zero {pad_zero}")
            del dh, dw
            ms = cuda_ms(lambda: spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=bf16), iters=10, warmup=2)
            plain_ms = cuda_ms(lambda: spmm_rowmask_bwd_plain(csr_t, w_t, g, fs, bf16, K2_PLAIN_EDGE_BLOCK),
                               iters=2, warmup=1)
            lib = {}
            for name, fn in (("sparse.mm", lambda: torch.sparse.mm(pattern, g)),
                             ("sampled_addmm", lambda: torch.sparse.sampled_addmm(pattern, fs, g.t(), beta=0.0))):
                try:  # a timed yardstick only; the port never calls it
                    lib[name] = cuda_ms(fn, iters=3, warmup=1)
                except RuntimeError as exc:
                    print(f"library yardstick {name} unavailable at F={f}: {exc}")
                    lib[name] = None
            lib_ms = None if None in lib.values() else sum(lib.values())
            bound_ms, bound_by, nbytes, ops = k2_bound(n, e, f)
            print(f"k2-main F={f}: {ms:.3f} ms (plain {plain_ms:.1f} ms, torch.sparse.mm "
                  f"{lib['sparse.mm']} ms + sampled_addmm {lib['sampled_addmm']} ms, bound {bound_ms:.3f} ms "
                  f"by {bound_by}); full-graph dh max_abs_err {dh_err:.3e} (err/sum|terms| "
                  f"{dh_ratio:.2e}), dw max_abs_err {dw_err:.3e} (err/sum|terms| {dw_ratio:.2e})")
            worst = max(worst, dh_err, dw_err)
            per_launch.append({"F": f, "E": e, "N": n, "stream": "bf16", "ms": ms, "plain_ms": plain_ms,
                               "longest_item": longest_item(csr_t, K2_CHUNK["one_head"]),
                               "library_ms": lib_ms, "library_parts_ms": lib, "bound_ms": bound_ms,
                               "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                               "dh_max_abs_err": dh_err, "dh_err_over_mass": dh_ratio,
                               "dw_max_abs_err": dw_err, "dw_err_over_mass": dw_ratio})
    return per_launch, worst, {"transpose_s": t1 - t0, "edge_perms_s": t2 - t1, "max_out_degree": max_out}


@timed_phase
def phase_training(dev, args, served):
    """The served GCN class trained on the full graph: the main path of the
    training slice."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd

    graph, feats, labels = served["graph"], served["feats"], served["labels"]
    model = build_model(graph, "auto", dev, args.seed).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=5e-4)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(feats), labels)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.item()

    t = time.perf_counter()
    warm_loss = step()
    warm_s = time.perf_counter() - t
    losses, times, per_step = [], [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        before = spmm_rowmask.launches, spmm_rowmask_bwd.launches
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
        per_step.append((spmm_rowmask.launches - before[0], spmm_rowmask_bwd.launches - before[1]))
    launches = read_counts()
    check(launches == only(K1=launches["K1"], K2=launches["K2"]), f"GCN training launched {launches}")
    print(f"train: warm step {warm_s:.3f} s (loss {warm_loss:.4f}); {TRAIN_STEPS} AdamW steps, "
          f"s per step {[round(t, 4) for t in times]}, losses {[round(v, 4) for v in losses]}, "
          f"launches per step (K1, K2) {per_step}")
    check(all(c == (3, 3) for c in per_step), f"a training step launched (K1, K2) {per_step}, expected (3, 3)")
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "non-finite training loss")
    check(losses[-1] < losses[0], f"the loss did not fall over {TRAIN_STEPS} steps: {losses}")
    return {"model": model, "optimizer": opt, "step": step, "launches": launches,
            "record": {"warm_s": warm_s, "warm_loss": warm_loss, "step_s": times, "losses": losses,
                       "launches_per_step": per_step, "launches": launches}}


@timed_phase
def phase_unweighted_step(dev, args, served):
    """``bench.py``'s training step formulation: the norms outside the SpMM,
    so it runs unweighted and its backward is K1 on the transpose."""
    from stgraph_tpu_torch.ops import message as M
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd
    from stgraph_tpu_torch.utils.norm import symmetric_norm

    graph, feats, labels = served["graph"], served["feats"], served["labels"]
    csr = graph.fwd_csr
    norm = symmetric_norm(graph)
    rng = np.random.default_rng(args.seed)
    ws = [torch.from_numpy((rng.standard_normal((a, b)) * 0.05).astype(np.float32)).to(dev).requires_grad_()
          for a, b in zip(GCN_DIMS[:-1], GCN_DIMS[1:])]

    def step():
        h = feats
        for i, w in enumerate(ws):
            h = M.spmm(csr, (h @ w) * norm, impl="kernel") * norm
            if i < len(ws) - 1:
                h = torch.relu(h)
        loss = torch.nn.functional.cross_entropy(h, labels)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item()

    step()  # warm
    spmm_rowmask.launches = spmm_rowmask_bwd.launches = 0
    t = time.perf_counter()
    loss = step()
    step_s = time.perf_counter() - t
    counts = (spmm_rowmask.launches, spmm_rowmask_bwd.launches)
    print(f"unweighted step: {step_s:.4f} s, loss {loss:.4f}, launches (K1, K2) {counts}")
    check(counts == (6, 0), f"the unweighted step launched (K1, K2) {counts}, expected (6, 0)")
    check(np.isfinite(loss) and all(bool(torch.isfinite(w.grad).all()) for w in ws), "non-finite step")
    return {"step_s": step_s, "loss": loss, "launches": {"K1": counts[0], "K2": counts[1]}}


@timed_phase
def phase_checkpoint_serve(dev, served, trained, workdir):
    """Save the trained model and optimizer, serve from the checkpoint, and
    hold each served layer to the trained layer's own forward on the same
    input (they differ only by the order of K1's split-row atomics)."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_plain
    from stgraph_tpu_torch.serve import Predictor
    from stgraph_tpu_torch.utils import Checkpointer
    from stgraph_tpu_torch.utils.norm import symmetric_norm
    from stgraph_tpu_torch.ops import message as M

    graph, feats = served["graph"], served["feats"]
    model, opt = trained["model"], trained["optimizer"]
    ckdir = os.path.join(workdir, "checkpoints")
    t = time.perf_counter()
    Checkpointer(ckdir).save(1 + TRAIN_STEPS, {"model": model.state_dict(), "optimizer": opt.state_dict()})
    save_s = time.perf_counter() - t
    like = {"model": model.state_dict(), "optimizer": opt.state_dict()}

    def apply_fn(state, x):
        return torch.func.functional_call(model, state["model"], (x,))

    t = time.perf_counter()
    predictor = Predictor.from_checkpoint(ckdir, apply_fn, like, (feats,), device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    captured = []
    hooks = [layer.register_forward_hook(lambda mod, inp, out: captured.append((inp[1], out)))
             for layer in model.layers]
    logits = predictor(feats)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    check(tuple(logits.shape) == (graph.get_num_nodes(), GCN_DIMS[-1]) and bool(torch.isfinite(logits).all()),
          "the checkpointed model served bad logits")
    csr = graph.fwd_csr
    worst, checks = 0.0, []
    with torch.inference_mode():
        w_abs = M.gather_src(csr, symmetric_norm(graph)).abs()
        bit_equal = torch.equal(logits, model(feats))
        for i, (layer, (x_in, y_served)) in enumerate(zip(model.layers, captured)):
            y = layer(graph, x_in)
            err = (y_served - y).abs()
            hw = x_in @ layer.weight
            mass = spmm_rowmask_plain(csr, w_abs, hw.abs(), torch.bfloat16, PLAIN_EDGE_BLOCK)
            mass = mass * symmetric_norm(graph)
            bound = KERNEL_TOL * mass + 1e-6 * y.abs()  # + one rounding of the bias add
            ok = bool((err <= bound).all())
            ratio = _err_over_mass(err, mass)
            print(f"checkpoint-serve layer {i}: max_abs_err {err.max().item():.3e} vs its own forward, "
                  f"worst err/(norm*sum|terms|) {ratio:.2e} {'ok' if ok else 'FAIL'}")
            check(ok, f"served layer {i} from the checkpoint disagrees with the trained layer")
            worst = max(worst, err.max().item())
            checks.append({"layer": i, "max_abs_err": err.max().item(), "err_over_mass": ratio})
    print(f"checkpoint-serve: save {save_s:.3f} s, from_checkpoint (restore + warm call) {restore_s:.3f} s, "
          f"logits bit-equal to the trained model's forward: {bit_equal}")
    return {"save_s": save_s, "restore_s": restore_s, "bit_equal": bit_equal, "layers": checks,
            "max_abs_err": worst}


@timed_phase
def phase_grads_vs_plain(dev, args, workdir):
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.nn import GCNConv

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    x = torch.from_numpy(data.get_all_features()).to(dev)
    y = torch.from_numpy(data.get_all_targets()).to(dev)
    grads = {}
    for impl in ("auto", "torch"):
        model = build_model(graph, impl, dev, args.seed)
        torch.nn.functional.cross_entropy(model(x), y).backward()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
    e = graph.get_num_edges()
    rng = np.random.default_rng(args.seed + 2)
    ew = torch.from_numpy(rng.random(e).astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.standard_normal((n, 47)).astype(np.float32)).to(dev)
    for impl in ("auto", "torch"):
        conv = GCNConv(100, 47, impl=impl, device=dev, generator=torch.Generator(device=dev).manual_seed(3))
        w = ew.clone().requires_grad_()
        (conv(graph, x, w) * r).sum().backward()
        grads[impl]["edge_weight"] = w.grad
        grads[impl]["conv.weight (weighted)"] = conv.weight.grad
    worst, rows = 0.0, []
    for k, ref in grads["torch"].items():
        err = (grads["auto"][k] - ref).abs().max().item()
        ratio = err / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        rows.append({"tensor": k, "max_abs_err": err, "err_over_max": ratio})
        print(f"grad-check {k}: kernel path vs plain torch path max_abs_err {err:.3e}, "
              f"{ratio:.2e} of the largest (tol {GRAD_TOL:g}) {'ok' if ratio <= GRAD_TOL else 'FAIL'}")
    check(worst <= GRAD_TOL, "a gradient on the kernel path disagrees with the plain path at scale 0.01")
    return {"n": n, "e": e, "grads": rows, "worst_err_over_max": worst}


@timed_phase
def phase_cora(dev, args, workdir):
    """``benchmarking/gcn/train.py`` on the port: 2 GCN layers, hidden 16,
    AdamW(1e-2, 5e-4), 200 full-graph epochs, the kernel route."""
    from stgraph_tpu_torch.dataset import CoraDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd
    from stgraph_tpu_torch.utils import accuracy

    STGraphDataset._offline = True  # no network here: the synthetic Cora, without a download attempt
    cora = CoraDataLoader(cache_dir=os.path.join(workdir, "datasets"))
    n = cora.gdata["num_nodes"]
    graph = StaticGraph(cora.get_edges(), None, n, device=dev)
    x = torch.from_numpy(cora.get_all_features()).to(dev)
    y = torch.from_numpy(cora.get_all_targets()).to(dev)
    model = build_model(graph, "kernel", dev, args.seed, dims=CORA_DIMS).train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=5e-4)
    spmm_rowmask.launches = spmm_rowmask_bwd.launches = 0
    times = []
    for epoch in range(CORA_EPOCHS):
        t = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        if epoch >= 3:
            times.append(time.perf_counter() - t)
    counts = (spmm_rowmask.launches, spmm_rowmask_bwd.launches)
    with torch.inference_mode():
        acc = accuracy(model(x), y)
    epoch_s = float(np.mean(times))
    print(f"cora: synthetic={cora.synthetic} N={n} E={cora.gdata['num_edges']}, {CORA_EPOCHS} epochs, "
          f"mean epoch (>=3) {epoch_s * 1e3:.3f} ms, final loss {loss.item():.4f}, train acc {acc:.4f}, "
          f"launches (K1, K2) {counts}")
    check(counts == (2 * CORA_EPOCHS, 2 * CORA_EPOCHS), f"Cora launched (K1, K2) {counts}")
    check(acc > 0.9, f"Cora train accuracy {acc:.4f} is not above 0.9")
    return {"synthetic": cora.synthetic, "epoch_s": epoch_s, "train_acc": acc, "loss": loss.item(),
            "launches": {"K1": counts[0], "K2": counts[1]}}


@timed_phase
def phase_tgcn(dev, rng):
    """TGCN, 3 timesteps forward and backward on a 200k-edge weighted graph
    (K1 and K2 stream bf16), against the same run on the CPU's plain path."""
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.nn import TGCN
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask, spmm_rowmask_bwd

    n, e, cin, cout, steps = 10_000, 200_000, 16, 32, 3
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n, e)], 1)
    ew = rng.random(e).astype(np.float32)
    xs = [rng.standard_normal((n, cin)).astype(np.float32) for _ in range(steps)]
    target = rng.standard_normal((n, cout)).astype(np.float32)
    ref_layer = TGCN(cin, cout, impl="kernel", device="cpu", generator=torch.Generator().manual_seed(5))
    results = []  # the CPU's plain path, then the card's kernel path
    for d in (torch.device("cpu"), dev):
        layer = TGCN(cin, cout, impl="kernel", device=d)
        layer.load_state_dict(ref_layer.state_dict())
        graph = StaticGraph(edges, None, n, device=d)
        w = torch.from_numpy(ew).to(d)
        x = [torch.from_numpy(v).to(d).requires_grad_() for v in xs]
        before = spmm_rowmask.launches, spmm_rowmask_bwd.launches
        h = None
        for xt in x:
            h = layer(graph, xt, w, h)
        ((h - torch.from_numpy(target).to(d)) ** 2).mean().backward()
        if d.type == "cuda":
            torch.cuda.synchronize()
            counts = (spmm_rowmask.launches - before[0], spmm_rowmask_bwd.launches - before[1])
            check(counts == (3 * steps, 3 * steps), f"TGCN launched (K1, K2) {counts}, expected 9 each")
        tensors = {"h": h.detach()}
        tensors.update({f"grad {k}": p.grad for k, p in layer.named_parameters()})
        tensors.update({f"grad x{i}": v.grad for i, v in enumerate(x)})
        results.append({k: v.cpu() for k, v in tensors.items()})
    worst = 0.0
    for k, ref in results[0].items():
        ratio = (results[1][k] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
    print(f"tgcn: N={n} E={e} {cin}->{cout}, {steps} timesteps fwd+bwd, CUDA kernel path vs CPU plain "
          f"path: worst max_abs_err / max |ref| over h and {len(results[0]) - 1} gradients "
          f"{worst:.2e} (tol {DEVICE_TOL:g}) {'ok' if worst <= DEVICE_TOL else 'FAIL'}")
    check(worst <= DEVICE_TOL, "TGCN on the card disagrees with the CPU's plain path")
    return {"n": n, "e": e, "worst_err_over_max": worst}


def k4_bound(n: int, e: int, h: int):
    """Least time for one K4 call (index form): indptr, cols and the (N, H)
    f32 table read once, the (N, H) output written once; or one compare per
    edge and head over the f32 peak."""
    nbytes = (n + 1) * 4 + e * 4 + 2 * n * h * 4
    ops = e * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k8_bound(n: int, e: int, h: int, f: int, aux: bool):
    """Least time for one K8 call: indptr, cols, el, er, m and the f32 fs
    table read once, out and den (and u, p) written once; or, per edge, ~7
    operations a head (9 with aux: add, leaky, subtract, min, exp, sums)
    and 2 a column (4 with aux) over the f32 peak."""
    hf = h * f
    nbytes = (n + 1) * 4 + e * 4 + 3 * n * h * 4 + n * hf * 4 + (n * hf + n * h) * 4 * (2 if aux else 1)
    ops = e * h * (9 if aux else 7) + e * hf * (4 if aux else 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k9_bound(n: int, e: int, h: int, f: int):
    """Least time for one K9 call: the transpose's indptr and cols, el, er,
    m, c and the f32 gu and fs tables read once, dfs and dl written once;
    or ~10 operations per edge and head and 4 per edge and column."""
    hf = h * f
    nbytes = (n + 1) * 4 + e * 4 + 4 * n * h * 4 + 3 * n * hf * 4 + n * h * 4
    ops = e * h * 10 + e * hf * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def _stats(outs, refs, masses):
    """Per output: (max_abs_err, worst err / sum|terms|, max |plain|)."""
    rows = []
    for out, ref, mass in zip(outs, refs, masses):
        err = (out - ref).abs()
        rows.append((err.max().item(), _err_over_mass(err, mass), ref.abs().max().item()))
    return rows


def k8_agreement(outs, csr, el, er, m, fs, h, stream, edge_block=None, rate=0.0, seed=None):
    """Hold K8's (out, den[, u, p]) against its plain version. The sums of
    absolute terms come from the plain version on |fs| (the weights and the
    keep factors are not negative): sum w q |fs| / den for out, sum w lp q
    |fs| for u, and den and p themselves."""
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_fwd_plain

    aux = outs[2] is not None
    refs = flash_gat_fwd_plain(csr, el, er, m, fs, h, GAT_SLOPE, stream, aux, edge_block, rate, seed)
    masses = flash_gat_fwd_plain(csr, el, er, m, fs.abs(), h, GAT_SLOPE, stream, aux, edge_block, rate, seed)
    keep = [i for i, r in enumerate(refs) if r is not None]
    return _stats([outs[i] for i in keep], [refs[i] for i in keep], [masses[i] for i in keep])


def k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, stream, edge_block=None, rate=0.0, seed=None):
    """Hold K9's (dfs, dl) against its plain version. Sums of absolute
    terms: sum w q |gu| for dfs; sum w lp (q sum_f |fs gu| + |c|) for dl,
    the plain version on |fs|, |gu| and -|c|."""
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_bwd_plain

    refs = flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, stream, edge_block, rate, seed)
    masses = flash_gat_bwd_plain(csr_t, el, er, m, -c.abs(), gu.abs(), fs.abs(), h, GAT_SLOPE, stream,
                                 edge_block, rate, seed)
    return _stats((dfs, dl), refs, masses)


def _node_cotangents(g, out, den, h):
    """K9's node-level inputs from a cotangent g of the normalised output:
    gu = g / den and c = sum_f g * out / den, as the backward forms them."""
    n, hf = g.shape
    denom = den.clamp(min=torch.finfo(torch.float32).tiny)
    gu = (g.reshape(n, h, -1) / denom[:, :, None]).reshape(n, hf)
    c = (g * out).reshape(n, h, -1).sum(-1) / denom
    return gu, c


def keep_mask_check(dev, rng, csr, e):
    """The in-kernel hash (``stg_edge_keep_mask``, the device function K8 and
    K9 run) against the port's ``edge_keep_mask``, bit for bit: the check
    graph's (src, dst) pairs at 8 heads and a million random pairs with ids
    up to 2^31 - 2 at 21 heads, seeds 0, 2^32 - 1 and a random one."""
    from stgraph_tpu_torch.ops.flash_gat import edge_keep_mask, edge_keep_mask_kernel

    big = torch.from_numpy(rng.integers(0, 2**31 - 1, (2, 1_000_000)).astype(np.int32)).to(dev)
    cases = [(csr.cols[:e], csr.rows[:e], 8, 0.6), (big[0], big[1], 21, 0.35)]
    seeds = (0, 2**32 - 1, int(rng.integers(0, 2**32)))
    pairs, mismatched = 0, 0
    for seed in seeds:
        for src, dst, h, rate in cases:
            seed_t = torch.tensor([seed], device=dev)
            out = edge_keep_mask_kernel(src, dst, seed_t, h, rate)
            torch.cuda.synchronize()
            ref = edge_keep_mask(src, dst, seed_t, h, rate)
            mismatched += int((out.view(torch.int32) != ref.view(torch.int32)).sum().item())
            pairs += out.numel()
            del out, ref
    print(f"keep-mask-check: stg_edge_keep_mask vs edge_keep_mask over {pairs} (edge, head) pairs, seeds {seeds}: "
          f"{mismatched} bits differ {'ok' if mismatched == 0 else 'FAIL'}")
    check(pairs >= 10**7 and mismatched == 0, f"the in-kernel keep mask differs from edge_keep_mask at {mismatched}")
    return {"pairs": pairs, "seeds": list(seeds), "mismatched": mismatched}


@timed_phase
def phase_gat_kernels_vs_plain(dev, rng, n=200_000, e=4_000_000, hub_deg=300_000):
    """K4, K8 (with and without aux) and K9 against their plain versions on
    K2's check graph: 1000 empty rows, a 300k-edge hub in each direction;
    then the in-kernel keep mask, and K8 (with and without aux) and K9 in
    their dropout mode at rates ``GAT_CHECK_RATES``. K4's, K8's and K9's
    outputs take a block filled with NaN just before (``poisoned_call``);
    K4 also runs at items of ``K4_CHECK_CHUNK`` edges."""
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops import segment_kernels as SEG
    from stgraph_tpu_torch.ops.flash_gat import flash_gat_bwd, flash_gat_fwd, stability_max
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow, segment_max_narrow_plain

    empty, hub = 1000, 12_345
    src = rng.integers(0, n - empty, e)
    dst = rng.integers(0, n - empty, e)
    dst[:hub_deg] = hub
    src[-hub_deg:] = hub + 1
    csr = build_csr(src, dst, n, device=dev)
    csr_t = csr.transpose()
    results, worst = [], {"K4": 0.0, "K8": 0.0, "K9": 0.0, "K8_dropout": 0.0, "K9_dropout": 0.0}
    mask_check = keep_mask_check(dev, rng, csr, e)
    drop_seed = torch.tensor([int(rng.integers(0, 2**32))], device=dev)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    for h, f in GAT_CHECKS:
        el, er = randn(n, h), randn(n, h)
        fs, g = randn(n, h * f), randn(n, h * f)
        # K4 into a poisoned output, at its item length and at short items
        k4_ref = segment_max_narrow_plain(csr, el, index=csr.cols)
        k4_err = 0.0
        for chunk in (SEG.K4_CHUNK, K4_CHECK_CHUNK):
            saved, SEG.K4_CHUNK = SEG.K4_CHUNK, chunk
            try:
                segment_max_narrow(csr, el, index=csr.cols)  # the work items, built once
                elmax = poisoned_call((n, h), lambda: segment_max_narrow(csr, el, index=csr.cols))
                torch.cuda.synchronize()
            finally:
                SEG.K4_CHUNK = saved
            check(torch.equal(elmax, k4_ref), f"K4 disagrees with its plain version at H={h}, items of {chunk} edges")
            k4_err = max(k4_err, (elmax - k4_ref).abs().max().item())
        del k4_ref
        m = stability_max(csr, el, er, GAT_SLOPE)
        for stream in (torch.float32, torch.bfloat16):
            for rate in (0.0,) + GAT_CHECK_RATES:
                tag = f"H={h} F={f} {str(stream)[6:]} stream" + (f" dropout {rate}" if rate else "")
                k8, k9 = ("K8_dropout", "K9_dropout") if rate else ("K8", "K9")
                seed = drop_seed if rate else None
                fwd = {}
                for aux in (False, True):  # into a poisoned output: every row must be written
                    outs = poisoned_call((n, h * f), lambda: flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, stream,
                                                                           aux=aux, rate=rate, seed=seed))
                    torch.cuda.synchronize()
                    fwd[aux] = outs
                    stats = k8_agreement(outs, csr, el, er, m, fs, h, stream, GAT_PLAIN_EDGE_BLOCK, rate, seed)
                    ok = (all(r <= KERNEL_TOL for _, r, _ in stats)
                          and not outs[0][n - empty:].any().item() and not outs[1][n - empty:].any().item())
                    names = ("out", "den", "u", "p")
                    print(f"k8-check {tag} aux={aux}: " + "; ".join(
                        f"{nm} max_abs_err {a:.3e} (err/sum|terms| {r:.2e})"
                        for nm, (a, r, _) in zip(names, stats)) + f" (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                    check(ok, f"K8 disagrees with its plain version at {tag}, aux={aux}")
                    worst[k8] = max(worst[k8], *(a for a, _, _ in stats))
                    results.append({"kernel": k8, "case": tag, "aux": aux, "rate": rate,
                                    "stats": [{"output": nm, "max_abs_err": a, "err_over_mass": r,
                                               "max_abs_plain": mx} for nm, (a, r, mx) in zip(names, stats)]})
                gu, c = _node_cotangents(g, fwd[True][0], fwd[True][1], h)
                dfs, dl = poisoned_call((n, h * f), lambda: flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE,
                                                                          stream, rate=rate, seed=seed))
                torch.cuda.synchronize()
                (dfs_a, dfs_r, _), (dl_a, dl_r, _) = k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, stream,
                                                                   GAT_PLAIN_EDGE_BLOCK, rate, seed)
                ok = (dfs_r <= KERNEL_TOL and dl_r <= KERNEL_TOL
                      and not dfs[n - empty:].any().item() and not dl[n - empty:].any().item())
                print(f"k9-check {tag}: dfs max_abs_err {dfs_a:.3e} (err/sum|terms| {dfs_r:.2e}); dl max_abs_err "
                      f"{dl_a:.3e} (err/sum|terms| {dl_r:.2e}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"K9 disagrees with its plain version at {tag}")
                worst[k9] = max(worst[k9], dfs_a, dl_a)
                results.append({"kernel": k9, "case": tag, "rate": rate, "dfs_max_abs_err": dfs_a,
                                "dfs_err_over_mass": dfs_r, "dl_max_abs_err": dl_a, "dl_err_over_mass": dl_r})
        print(f"k4-check H={h}: bit-equal to its plain version into a poisoned output, items of "
              f"{SEG.K4_CHUNK} and {K4_CHECK_CHUNK} edges (max_abs_err {k4_err})")
        results.append({"kernel": "K4", "case": f"H={h}", "max_abs_err": k4_err})
    return {"graph": {"n": n, "e": e, "empty_rows": empty, "hub_deg": hub_deg},
            "keep_mask": mask_check, "cases": results, "max_abs_err": worst}


def gat_shapes(dims, heads):
    """(in, F, H) of each layer of ``benchmarking/gat/train.py``'s stack:
    ``len(heads) - 1`` hidden layers of ``hidden`` features a head, their
    heads concatenated, then the output layer."""
    fin, hidden, classes = dims
    ins = [fin] + [hidden * h for h in heads[:-1]]
    outs = [hidden] * (len(heads) - 1) + [classes]
    return list(zip(ins, outs, heads))


class GAT(torch.nn.Module):
    """``benchmarking/gat/train.py``'s model: GATConv layers with ELU, the
    heads concatenated, then a GATConv whose heads are averaged. Dropout
    (``feat_drop``, ``attn_drop`` on every layer) draws from the
    ``generator`` given to ``forward``."""

    def __init__(self, graph, dims, heads, impl, device, generator=None, feat_drop=0.0, attn_drop=0.0):
        super().__init__()
        from stgraph_tpu_torch.nn import GATConv

        shapes = gat_shapes(dims, heads)
        self.graph = graph
        self.layers = torch.nn.ModuleList(
            GATConv(a, f, h, feat_drop=feat_drop, attn_drop=attn_drop, negative_slope=GAT_SLOPE, impl=impl,
                    device=device, generator=generator,
                    activation=torch.nn.functional.elu if i < len(shapes) - 1 else None)
            for i, (a, f, h) in enumerate(shapes)
        )

    def forward(self, h, generator=None):
        for layer in self.layers[:-1]:
            h = layer(self.graph, h, generator).reshape(h.shape[0], -1)
        return self.layers[-1](self.graph, h, generator).mean(1)


def numpy_gat_params(dims, heads, seed):
    """A flax-shaped GAT parameter tree made with numpy from ``seed``: the
    JAX layer's initialiser, variance_scaling(2.0, fan_avg, normal), on
    ``fc.kernel`` (in, H*F) and on the (H, F) attention vectors."""
    rng = np.random.default_rng(seed)
    tree = {}
    for i, (a, f, h) in enumerate(gat_shapes(dims, heads)):
        def normal(shape):
            return (rng.standard_normal(shape) * np.sqrt(4.0 / sum(shape))).astype(np.float32)

        tree[f"GATConv_{i}"] = {"fc": {"kernel": normal((a, h * f))}, "attn_l": normal((h, f)),
                                "attn_r": normal((h, f))}
    return {"params": tree}


def build_gat(graph, impl, dev, seed, dims=GAT_DIMS, heads=GAT_HEADS, feat_drop=0.0, attn_drop=0.0):
    from stgraph_tpu_torch.convert import gat_params_from_jax

    model = GAT(graph, dims, heads, impl, dev, feat_drop=feat_drop, attn_drop=attn_drop)
    model.load_state_dict(gat_params_from_jax(numpy_gat_params(dims, heads, seed)))
    return model.eval()


@timed_phase
def phase_gat_serving(dev, args, base):
    """The GAT behind a ``Predictor`` on the full graph: 3 requests, each
    launching K4 and K8 twice (no aux outputs) and nothing else."""
    from stgraph_tpu_torch.serve import Predictor

    graph, feats = base["graph"], base["feats"]
    n = graph.get_num_nodes()
    t = time.perf_counter()
    model = build_gat(graph, "auto", dev, args.seed)
    predictor = Predictor.build(model, dict(model.state_dict()), (feats,), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    captured = []
    hooks = [layer.register_forward_hook(lambda mod, inp, out: captured.append(inp[1]))
             for layer in model.layers]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    requests = [feats] + [
        feats + 0.1 * torch.randn(feats.shape, device=dev, generator=gen) for _ in range(REQUESTS - 1)
    ]
    torch.cuda.synchronize()
    times, per_request = [], []
    reset_counts()
    for r, x in enumerate(requests):
        before = read_counts()
        t = time.perf_counter()
        logits = predictor(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if r == 0:
            for hk in hooks:
                hk.remove()
        delta = {k: v - before[k] for k, v in read_counts().items()}
        per_request.append(delta)
        check(delta == only(K4=2, K8=2),
              f"GAT request {r} launched {delta}, expected K4 and K8 twice each")
        check(tuple(logits.shape) == (n, GAT_DIMS[-1]), f"GAT logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all().item()), f"GAT request {r}: non-finite logits")
    counts = read_counts()
    print(f"gat-serve: model+Predictor.build (warm call) {build_s:.2f} s; {REQUESTS} requests, launches "
          f"{counts}, per-request s {[round(v, 4) for v in times]}, logits finite, shape {tuple(logits.shape)}")
    return {"model": model, "predictor": predictor, "inputs": captured, "counts": counts,
            "record": {"build_s": build_s, "request_s": times, "launches": counts,
                       "launches_per_request": per_request}}


def _library_k4_ms(csr, el, e):
    """``torch.segment_reduce(max)`` over the gathered (E, H) plane (the
    gather itself not timed): a timed yardstick only."""
    try:
        plane = el.index_select(0, csr.cols[:e].long())
        offsets = csr.indptr.long()
        ms = cuda_ms(lambda: torch.segment_reduce(plane, "max", offsets=offsets, unsafe=True), iters=5)
        del plane
        return ms
    except (RuntimeError, TypeError) as exc:
        print(f"library yardstick segment_reduce unavailable: {exc}")
        return None


def _library_k8_ms(csr, el, er, fs, h, e):
    """Per head, ``torch.sparse.softmax`` of the scores over the CSR's
    pattern and ``torch.sparse.mm`` of the result with that head's features:
    two timed calls a head, summed; a timed yardstick only."""
    try:
        rows, cols = csr.rows[:e].long(), csr.cols[:e].long()
        idx = torch.stack([rows, cols])
        n = csr.num_nodes
        f = fs.shape[1] // h
        total = 0.0
        for k in range(h):
            s = el[cols, k] + er[rows, k]
            s = torch.where(s >= 0, s, GAT_SLOPE * s)
            # the CSR's edge order is row-major sorted, as a coalesced COO's
            a = torch.sparse_coo_tensor(idx, s, (n, n), is_coalesced=True)
            alpha = torch.sparse.softmax(a, dim=1)
            x = fs[:, k * f:(k + 1) * f].contiguous()
            total += cuda_ms(lambda: torch.sparse.softmax(a, dim=1), iters=3)
            total += cuda_ms(lambda: torch.sparse.mm(alpha, x), iters=3)
            del a, alpha, x, s
        return total
    except (RuntimeError, TypeError) as exc:
        print(f"library yardstick sparse.softmax + sparse.mm unavailable: {exc}")
        return None


@timed_phase
def phase_gat_kernels_at_main_shapes(dev, gat):
    """K4, K8 and K9 on the full graph with each GAT layer's own scores and
    features (captured from the first request) and a random cotangent; then
    K8 (aux) and K9 in their dropout mode (``GAT_ATTN_DROP``) on the same
    inputs, timed in turns with the mode without dropout."""
    from stgraph_tpu_torch.ops.flash_gat import (flash_gat_bwd, flash_gat_bwd_plain, flash_gat_fwd,
                                                 flash_gat_fwd_plain, stability_max)
    from stgraph_tpu_torch.ops.segment_kernels import K4_CHUNK, segment_max_narrow, segment_max_narrow_plain
    from stgraph_tpu_torch.ops.spmm_kernels import FLASH_CHUNK

    graph = gat["model"].graph
    csr = graph.fwd_csr
    csr_t = csr.transpose()
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(11)
    seed = torch.randint(0, 1 << 32, (1,), generator=gen, device=dev, dtype=torch.int64)
    rate = GAT_ATTN_DROP
    out = {"K4": [], "K8": [], "K8_serving": [], "K9": [], "K8_dropout": [], "K9_dropout": []}
    worst = {"K4": 0.0, "K8": 0.0, "K9": 0.0, "K8_dropout": 0.0, "K9_dropout": 0.0}
    with torch.inference_mode():
        for layer, h_in in zip(gat["model"].layers, gat["inputs"]):
            h, f = layer.num_heads, layer.out_feats
            feat_src = layer.fc(h_in).reshape(n, h, f)
            el = (feat_src * layer.attn_l).sum(-1)
            er = (feat_src * layer.attn_r).sum(-1)
            fs = feat_src.reshape(n, h * f)
            del feat_src
            # K4: exact, so its plain version must agree bit for bit
            elmax = segment_max_narrow(csr, el, index=csr.cols)
            torch.cuda.synchronize()
            k4_err = (elmax - segment_max_narrow_plain(csr, el, index=csr.cols, edge_block=1 << 24)).abs().max().item()
            check(k4_err == 0.0, f"K4 at H={h} (full graph) disagrees: {k4_err}")
            k4_ms = cuda_ms(lambda: segment_max_narrow(csr, el, index=csr.cols), iters=10, warmup=2)
            k4_plain = cuda_ms(lambda: segment_max_narrow_plain(csr, el, index=csr.cols, edge_block=1 << 24),
                               iters=1, warmup=1)
            k4_lib = _library_k4_ms(csr, el, e)
            bound = k4_bound(n, e, h)
            print(f"k4-main H={h}: {k4_ms:.3f} ms (plain {k4_plain:.1f} ms, segment_reduce {k4_lib} ms, "
                  f"bound {bound[0]:.3f} ms by {bound[1]}); bit-equal to its plain version")
            out["K4"].append({"H": h, "F": h, "E": e, "N": n, "ms": k4_ms, "plain_ms": k4_plain,
                              "longest_item": longest_item(csr, K4_CHUNK),
                              "library_ms": k4_lib, "bound_ms": bound[0], "bound_by": bound[1],
                              "bytes": bound[2], "ops": bound[3], "max_abs_err": k4_err})
            m = stability_max(csr, el, er, GAT_SLOPE)
            # K8 with the aux outputs (a training step's) and without (a request's)
            outs = flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16, aux=True)
            plain_outs = flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16)
            torch.cuda.synchronize()
            stats = k8_agreement(outs, csr, el, er, m, fs, h, bf16, GAT_PLAIN_EDGE_BLOCK)
            stats_na = k8_agreement(plain_outs, csr, el, er, m, fs, h, bf16, GAT_PLAIN_EDGE_BLOCK)
            del plain_outs
            check(all(r <= KERNEL_TOL for _, r, _ in stats + stats_na),
                  f"K8 at H={h}, F={f} (full graph) disagrees: {stats}, {stats_na}")
            k8_err = max(a for a, _, _ in stats + stats_na)
            ms_aux = cuda_ms(lambda: flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16, aux=True),
                             iters=10, warmup=2)
            ms_na = cuda_ms(lambda: flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16), iters=10, warmup=2)
            plain_aux = cuda_ms(lambda: flash_gat_fwd_plain(csr, el, er, m, fs, h, GAT_SLOPE, bf16, True,
                                                            GAT_PLAIN_EDGE_BLOCK), iters=1, warmup=1)
            plain_na = cuda_ms(lambda: flash_gat_fwd_plain(csr, el, er, m, fs, h, GAT_SLOPE, bf16, False,
                                                           GAT_PLAIN_EDGE_BLOCK), iters=1, warmup=1)
            k8_lib = _library_k8_ms(csr, el, er, fs, h, e)
            b_aux, b_na = k8_bound(n, e, h, f, True), k8_bound(n, e, h, f, False)
            print(f"k8-main H={h} F={f}: aux {ms_aux:.3f} ms / no aux {ms_na:.3f} ms (plain {plain_aux:.1f} / "
                  f"{plain_na:.1f} ms, sparse.softmax + sparse.mm {k8_lib} ms, bound {b_aux[0]:.3f} / "
                  f"{b_na[0]:.3f} ms by {b_aux[1]}); full-graph " + "; ".join(
                      f"{nm} max_abs_err {a:.3e} (err/sum|terms| {r:.2e})"
                      for nm, (a, r, _) in zip(("out", "den", "u", "p"), stats)))
            for key, ms, plain_ms, b, aux in (("K8", ms_aux, plain_aux, b_aux, True),
                                              ("K8_serving", ms_na, plain_na, b_na, False)):
                out[key].append({"H": h, "F": f, "E": e, "N": n, "aux": aux, "ms": ms, "plain_ms": plain_ms,
                                 "longest_item": longest_item(csr, FLASH_CHUNK["fwd"]),
                                 "library_ms": k8_lib, "bound_ms": b[0], "bound_by": b[1], "bytes": b[2],
                                 "ops": b[3], "max_abs_err": k8_err,
                                 "err_over_mass": max(r for _, r, _ in stats)})
            # K9 on the transpose, with a random cotangent of the output
            g = torch.randn(fs.shape, device=dev, generator=gen)
            gu, c = _node_cotangents(g, outs[0], outs[1], h)
            del g, outs
            dfs, dl = flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16)
            torch.cuda.synchronize()
            (dfs_a, dfs_r, _), (dl_a, dl_r, _) = k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, bf16,
                                                               GAT_PLAIN_EDGE_BLOCK)
            check(dfs_r <= KERNEL_TOL and dl_r <= KERNEL_TOL,
                  f"K9 at H={h}, F={f} (full graph) disagrees: dfs {dfs_r}, dl {dl_r}")
            del dfs, dl
            k9_ms = cuda_ms(lambda: flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16),
                            iters=10, warmup=2)
            k9_plain = cuda_ms(lambda: flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16,
                                                           GAT_PLAIN_EDGE_BLOCK), iters=1, warmup=1)
            b9 = k9_bound(n, e, h, f)
            print(f"k9-main H={h} F={f}: {k9_ms:.3f} ms (plain {k9_plain:.1f} ms, no library call, bound "
                  f"{b9[0]:.3f} ms by {b9[1]}); full-graph dfs max_abs_err {dfs_a:.3e} (err/sum|terms| "
                  f"{dfs_r:.2e}), dl max_abs_err {dl_a:.3e} (err/sum|terms| {dl_r:.2e})")
            out["K9"].append({"H": h, "F": f, "E": e, "N": n, "ms": k9_ms, "plain_ms": k9_plain,
                              "longest_item": longest_item(csr_t, FLASH_CHUNK["bwd"]), "library_ms": None, "bound_ms": b9[0], "bound_by": b9[1], "bytes": b9[2],
                              "ops": b9[3], "dfs_max_abs_err": dfs_a, "dfs_err_over_mass": dfs_r,
                              "dl_max_abs_err": dl_a, "dl_err_over_mass": dl_r})
            # The dropout mode on the same inputs: full outputs against the
            # plain versions, then timed in turns with the mode without it
            # (none, dropout, dropout, none). The mask adds no bytes, so the
            # bounds are the same; no PyTorch call computes the function.
            outs = flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16, aux=True, rate=rate, seed=seed)
            torch.cuda.synchronize()
            stats = k8_agreement(outs, csr, el, er, m, fs, h, bf16, GAT_PLAIN_EDGE_BLOCK, rate, seed)
            check(all(r <= KERNEL_TOL for _, r, _ in stats),
                  f"K8's dropout mode at H={h}, F={f} (full graph) disagrees: {stats}")
            k8d_err = max(a for a, _, _ in stats)
            del outs
            dfs, dl = flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16, rate=rate, seed=seed)
            torch.cuda.synchronize()
            (dfsd_a, dfsd_r, _), (dld_a, dld_r, _) = k9_agreement(dfs, dl, csr_t, el, er, m, c, gu, fs, h, bf16,
                                                                   GAT_PLAIN_EDGE_BLOCK, rate, seed)
            check(dfsd_r <= KERNEL_TOL and dld_r <= KERNEL_TOL,
                  f"K9's dropout mode at H={h}, F={f} (full graph) disagrees: dfs {dfsd_r}, dl {dld_r}")
            del dfs, dl

            def k8_call(drop):
                return lambda: flash_gat_fwd(csr, el, er, m, fs, h, GAT_SLOPE, bf16, aux=True,
                                             rate=rate if drop else 0.0, seed=seed if drop else None)

            def k9_call(drop):
                return lambda: flash_gat_bwd(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16,
                                             rate=rate if drop else 0.0, seed=seed if drop else None)

            turns = {}
            for key, call in (("K8", k8_call), ("K9", k9_call)):
                times = [cuda_ms(call(drop), iters=10, warmup=2) for drop in (False, True, True, False)]
                turns[key] = ((times[1] + times[2]) / 2, (times[0] + times[3]) / 2, times)
            k8d_plain = cuda_ms(lambda: flash_gat_fwd_plain(csr, el, er, m, fs, h, GAT_SLOPE, bf16, True,
                                                            GAT_PLAIN_EDGE_BLOCK, rate, seed), iters=1, warmup=1)
            k9d_plain = cuda_ms(lambda: flash_gat_bwd_plain(csr_t, el, er, m, c, gu, fs, h, GAT_SLOPE, bf16,
                                                            GAT_PLAIN_EDGE_BLOCK, rate, seed), iters=1, warmup=1)
            k8d_errs = {"max_abs_err": k8d_err, "err_over_mass": max(r for _, r, _ in stats)}
            k9d_errs = {"dfs_max_abs_err": dfsd_a, "dfs_err_over_mass": dfsd_r, "dl_max_abs_err": dld_a,
                        "dl_err_over_mass": dld_r}
            for key, plain_ms, b, errs in (("K8", k8d_plain, b_aux, k8d_errs), ("K9", k9d_plain, b9, k9d_errs)):
                ms, ms_none, times = turns[key]
                print(f"{key.lower()}-dropout-main H={h} F={f} rate {rate}: {ms:.3f} ms against {ms_none:.3f} ms "
                      f"without dropout, in turns none/dropout/dropout/none {[round(t, 3) for t in times]} "
                      f"({100 * (ms / ms_none - 1):+.1f} %; plain {plain_ms:.1f} ms, no library call, bound "
                      f"{b[0]:.3f} ms by {b[1]}); full-graph " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
                out[f"{key}_dropout"].append(dict(
                    {"H": h, "F": f, "E": e, "N": n, "aux": True, "rate": rate, "ms": ms, "ms_without_dropout": ms_none,
                     "turns_ms": times, "plain_ms": plain_ms, "library_ms": None, "bound_ms": b[0],
                     "bound_by": b[1], "bytes": b[2], "ops": b[3]}, **errs))
            worst["K8_dropout"] = max(worst["K8_dropout"], k8d_err)
            worst["K9_dropout"] = max(worst["K9_dropout"], dfsd_a, dld_a)
            worst["K4"] = max(worst["K4"], k4_err)
            worst["K8"] = max(worst["K8"], k8_err)
            worst["K9"] = max(worst["K9"], dfs_a, dl_a)
            del el, er, m, fs, gu, c, elmax
            torch.cuda.empty_cache()
    return out, worst


@timed_phase
def phase_gat_training(dev, args, base):
    """The GAT trained on the full graph with Adam(5e-3): the fourth main
    path. Every step launches K4, K8 (with aux) and K9 twice each."""
    graph, feats, labels = base["graph"], base["feats"], base["labels"]
    model = build_gat(graph, "auto", dev, args.seed).train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(feats), labels)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.item()

    t = time.perf_counter()
    warm_loss = step()
    warm_s = time.perf_counter() - t
    losses, times, per_step = [], [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        before = read_counts()
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
    counts = read_counts()
    print(f"gat-train: warm step {warm_s:.3f} s (loss {warm_loss:.4f}); {TRAIN_STEPS} Adam steps, s per step "
          f"{[round(v, 4) for v in times]}, losses {[round(v, 4) for v in losses]}, launches {counts}")
    check(all(c == only(K4=2, K8=2, K9=2) for c in per_step),
          f"a GAT training step launched {per_step}, expected K4, K8 and K9 twice each")
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "non-finite GAT training loss")
    check(losses[-1] < losses[0], f"the GAT loss did not fall over {TRAIN_STEPS} steps: {losses}")
    return {"model": model, "optimizer": opt, "step": step, "counts": counts,
            "record": {"warm_s": warm_s, "warm_loss": warm_loss, "step_s": times, "losses": losses,
                       "launches_per_step": per_step, "launches": counts}}


@timed_phase
def phase_gat_dropout_training(dev, args, base):
    """gat-dropout-training, the twelfth main path: the GAT trained on the
    full graph as the GAT paper trains it, ``feat_drop`` and ``attn_drop``
    0.6 on both layers, Adam(5e-3), 1 warm step and 5 timed ones. Every
    step launches K4, K8 (with aux) and K9 twice each, all of K8's and K9's
    in the dropout mode; a profile of one step; then the peak device memory
    of a step with ``attn_drop`` alone against the same model's step
    without dropout."""
    graph, feats, labels = base["graph"], base["feats"], base["labels"]
    model = build_gat(graph, "auto", dev, args.seed, feat_drop=GAT_FEAT_DROP, attn_drop=GAT_ATTN_DROP).train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(feats, gen), labels)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.item()

    t = time.perf_counter()
    warm_loss = step()
    warm_s = time.perf_counter() - t
    losses, times, per_step = [], [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        before = read_counts()
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
    counts = read_counts()
    print(f"gat-dropout-train: feat_drop {GAT_FEAT_DROP}, attn_drop {GAT_ATTN_DROP}; warm step {warm_s:.3f} s "
          f"(loss {warm_loss:.4f}); {TRAIN_STEPS} Adam steps, s per step {[round(v, 4) for v in times]}, losses "
          f"{[round(v, 4) for v in losses]}, launches {counts}")
    check(all(c == only(K4=2, K8=2, K9=2, K8_dropout=2, K9_dropout=2) for c in per_step),
          f"a GAT dropout training step launched {per_step}, expected K4, K8 and K9 twice each, K8 and K9 in "
          "the dropout mode")
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "non-finite GAT dropout training loss")
    check(losses[-1] < losses[0], f"the GAT dropout loss did not fall over {TRAIN_STEPS} steps: {losses}")
    profile = phase_profile(step, "one GAT attention-dropout training step")
    peaks = {}
    for label, rate in (("attn_drop", GAT_ATTN_DROP), ("none", 0.0)):
        for layer in model.layers:
            layer.feat_drop, layer.attn_drop = 0.0, rate
        step()
        torch.cuda.reset_peak_memory_stats()
        step()
        peaks[label] = torch.cuda.max_memory_allocated()
    extra = peaks["attn_drop"] - peaks["none"]
    ok = extra <= DROPOUT_PEAK_SLACK
    print(f"gat-dropout-memory: peak of a step with attn_drop {GAT_ATTN_DROP} {peaks['attn_drop'] / 2**30:.3f} GiB, "
          f"without dropout {peaks['none'] / 2**30:.3f} GiB: {extra / 2**20:+.1f} MiB (at most "
          f"{DROPOUT_PEAK_SLACK >> 20} MiB) {'ok' if ok else 'FAIL'}")
    check(ok, f"an attention-dropout step peaks {extra / 2**20:.1f} MiB above the same step without dropout")
    return {"counts": counts,
            "record": {"warm_s": warm_s, "warm_loss": warm_loss, "step_s": times, "losses": losses,
                       "launches_per_step": per_step, "launches": counts, "profile": profile,
                       "peak_bytes": peaks, "peak_extra_bytes": extra}}


@timed_phase
def phase_gat_dropout_vs_plain(dev, args, workdir):
    """The GAT with ``attn_drop`` at ``--scale 0.01``: logits and every
    parameter's gradient on the flash route (K8's and K9's dropout mode, a
    bf16 stream) against the same layers on the edge-domain route (plain
    torch, f32) given the same hash masks: the seeds a twin generator draws,
    hashed by ``edge_keep_mask`` over the CSR."""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.nn.gat_conv import attention_dropout_seed
    from stgraph_tpu_torch.ops.attention import composed_gat_attention_dropout
    from stgraph_tpu_torch.ops.flash_gat import edge_keep_mask

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    csr = graph.fwd_csr
    x = torch.from_numpy(data.get_all_features()).to(dev)
    y = torch.from_numpy(data.get_all_targets()).to(dev)
    model = build_gat(graph, "auto", dev, args.seed, attn_drop=GAT_ATTN_DROP).train()
    reset_counts()
    out = model(x, torch.Generator(device=dev).manual_seed(args.seed + 17))
    torch.nn.functional.cross_entropy(out, y).backward()
    counts = read_counts()
    check(counts == only(K4=2, K8=2, K9=2, K8_dropout=2, K9_dropout=2),
          f"the scale-0.01 dropout GAT launched {counts}, expected K4, K8 and K9 twice each in the dropout mode")
    grads = {k: p.grad for k, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    twin = torch.Generator(device=dev).manual_seed(args.seed + 17)
    h = x
    for i, layer in enumerate(model.layers):
        heads, f = layer.num_heads, layer.out_feats
        feat_src = layer.fc(h).reshape(n, heads, f)
        el = (feat_src * layer.attn_l).sum(-1, keepdim=True)
        er = (feat_src * layer.attn_r).sum(-1, keepdim=True)
        keep = edge_keep_mask(csr.cols, csr.rows, attention_dropout_seed(twin, dev), heads, GAT_ATTN_DROP)
        h = composed_gat_attention_dropout(csr, el, er, feat_src, GAT_SLOPE, GAT_ATTN_DROP, keep=keep)
        h = torch.nn.functional.elu(h).reshape(n, -1) if i < len(model.layers) - 1 else h.mean(1)
    torch.nn.functional.cross_entropy(h, y).backward()
    err = (out - h).detach().abs().max().item()
    scale = h.detach().abs().max().item()
    ok = err <= MODEL_TOL * scale
    print(f"gat-dropout-model-check scale 0.01 (N={n}, E={graph.get_num_edges()}, attn_drop {GAT_ATTN_DROP}): "
          f"flash route vs the edge-domain route with the same hash masks max_abs_err {err:.3e} (max |plain| "
          f"{scale:.3f}, tol {MODEL_TOL:g} x that) {'ok' if ok else 'FAIL'}")
    check(ok, "the dropout GAT's logits on the flash route disagree with the edge-domain route at scale 0.01")
    worst, rows = 0.0, []
    for k, p in model.named_parameters():
        gerr = (grads[k] - p.grad).abs().max().item()
        ratio = gerr / max(p.grad.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        rows.append({"tensor": k, "max_abs_err": gerr, "err_over_max": ratio})
        print(f"gat-dropout-grad-check {k}: flash route vs edge-domain route max_abs_err {gerr:.3e}, {ratio:.2e} of "
              f"the largest (tol {GRAD_TOL:g}) {'ok' if ratio <= GRAD_TOL else 'FAIL'}")
    check(worst <= GRAD_TOL,
          "a dropout GAT gradient on the flash route disagrees with the edge-domain route at scale 0.01")
    return {"n": n, "e": graph.get_num_edges(), "launches": counts, "max_abs_err": err, "max_abs_plain": scale,
            "grads": rows, "worst_grad_err_over_max": worst}


@timed_phase
def phase_gat_vs_plain(dev, args, workdir):
    """The GAT at ``--scale 0.01``: logits and every parameter's gradient on
    the flash route (bf16 stream) against the vertex program (f32)."""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    x = torch.from_numpy(data.get_all_features()).to(dev)
    y = torch.from_numpy(data.get_all_targets()).to(dev)
    logits, grads = {}, {}
    for impl in ("auto", "torch"):
        model = build_gat(graph, impl, dev, args.seed)
        plain = impl == "torch"
        with plain_narrow_kernels() if plain else contextlib.nullcontext(), \
                plain_wide_kernels() if plain else contextlib.nullcontext():
            out = model(x)
            torch.nn.functional.cross_entropy(out, y).backward()
        logits[impl] = out.detach()
        grads[impl] = {k: p.grad for k, p in model.named_parameters()}
        del model, out
    err = (logits["auto"] - logits["torch"]).abs().max().item()
    scale = logits["torch"].abs().max().item()
    ok = err <= MODEL_TOL * scale
    print(f"gat-model-check scale 0.01 (N={n}, E={graph.get_num_edges()}): flash route vs the vertex program "
          f"max_abs_err {err:.3e} (max |plain| {scale:.3f}, tol {MODEL_TOL:g} x that) {'ok' if ok else 'FAIL'}")
    check(ok, "the GAT's logits on the flash route disagree with the plain path at scale 0.01")
    worst, rows = 0.0, []
    for k, ref in grads["torch"].items():
        gerr = (grads["auto"][k] - ref).abs().max().item()
        ratio = gerr / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        rows.append({"tensor": k, "max_abs_err": gerr, "err_over_max": ratio})
        print(f"gat-grad-check {k}: flash route vs plain path max_abs_err {gerr:.3e}, {ratio:.2e} of the "
              f"largest (tol {GRAD_TOL:g}) {'ok' if ratio <= GRAD_TOL else 'FAIL'}")
    check(worst <= GRAD_TOL, "a GAT gradient on the flash route disagrees with the plain path at scale 0.01")
    return {"n": n, "e": graph.get_num_edges(), "max_abs_err": err, "max_abs_plain": scale, "grads": rows,
            "worst_grad_err_over_max": worst}


@timed_phase
def phase_pubmed_gat(dev, args, workdir):
    """``benchmarking/gat/train.py --dataset pubmed`` on the port: 8 heads x
    8 hidden, 1 output head, Adam(5e-3), 200 full-graph epochs, the flash
    route (88,648 edges: an f32 stream)."""
    from stgraph_tpu_torch.dataset import PubmedDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.utils import accuracy

    STGraphDataset._offline = True  # no network here: the synthetic Pubmed, without a download attempt
    t = time.perf_counter()
    pubmed = PubmedDataLoader(cache_dir=os.path.join(workdir, "datasets"))
    data_s = time.perf_counter() - t
    n = pubmed.gdata["num_nodes"]
    graph = StaticGraph(pubmed.get_edges(), None, n, device=dev)
    x = torch.from_numpy(pubmed.get_all_features()).to(dev)
    y = torch.from_numpy(pubmed.get_all_targets()).to(dev)
    # The layers' own initialiser, as train.py uses its package's, drawn on
    # the CPU from --seed so that the draw does not depend on the device
    gen = torch.Generator().manual_seed(args.seed)
    model = GAT(graph, PUBMED_DIMS, PUBMED_HEADS, "auto", torch.device("cpu"), gen).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    reset_counts()
    times = []
    for epoch in range(PUBMED_EPOCHS):
        t = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        if epoch >= 3:
            times.append(time.perf_counter() - t)
    counts = read_counts()
    with torch.inference_mode():
        acc = accuracy(model(x), y)
    epoch_s = float(np.mean(times))
    print(f"pubmed-gat: synthetic={pubmed.synthetic} N={n} E={pubmed.gdata['num_edges']} (data {data_s:.1f} s), "
          f"{PUBMED_EPOCHS} epochs, mean epoch (>=3) {epoch_s * 1e3:.3f} ms, final loss {loss.item():.4f}, "
          f"train acc {acc:.4f} (floor {PUBMED_ACC_FLOOR:.4f}), launches {counts}")
    check(counts == only(K4=2 * PUBMED_EPOCHS, K8=2 * PUBMED_EPOCHS, K9=2 * PUBMED_EPOCHS),
          f"Pubmed GAT launched {counts}")
    check(acc >= PUBMED_ACC_FLOOR, f"Pubmed GAT train accuracy {acc:.4f} is below {PUBMED_ACC_FLOOR:.4f}")
    return {"synthetic": pubmed.synthetic, "epoch_s": epoch_s, "train_acc": acc, "loss": loss.item(),
            "launches": counts, "data_s": data_s}


# -- the composed GAT route: K3 and K10 ---------------------------------------


@contextlib.contextmanager
def plain_wide_kernels():
    """Inside, K5's and the no-gather sum's wrappers run their plain versions
    on any device, the sum in f64 with no bf16 stream, so that a reference
    run of the vertex program (whose wide sums and maxima reach them through
    ``aggregate``) launches no kernel and rounds nothing to bf16."""
    from stgraph_tpu_torch.ops import segment_kernels as SK

    saved = SK.segment_max_wide, SK.segment_sum_wide
    SK.segment_max_wide = lambda csr, vals: SK.segment_max_wide_plain(csr, vals, 1 << 18)
    SK.segment_sum_wide = lambda csr, vals: SK.segment_sum_wide_plain(csr, vals.double(), 1 << 18)
    try:
        yield
    finally:
        SK.segment_max_wide, SK.segment_sum_wide = saved


@contextlib.contextmanager
def plain_narrow_kernels():
    """Inside, K3's and K4's wrappers run their plain versions on any device,
    so that a reference run of the vertex program (whose narrow sums and
    maxima reach them through ``aggregate``) launches no kernel."""
    from stgraph_tpu_torch.ops import segment_kernels as SK

    saved = SK.segment_max_narrow, SK.segment_sum_narrow
    SK.segment_max_narrow = lambda csr, vals, index=None: SK.segment_max_narrow_plain(csr, vals, index, 1 << 24)
    SK.segment_sum_narrow = lambda csr, vals: SK.segment_sum_narrow_plain(csr, vals, 1 << 24)
    try:
        yield
    finally:
        SK.segment_max_narrow, SK.segment_sum_narrow = saved


def k3_bound(n: int, e: int, k: int):
    """Least time for one K3 call: indptr and the (E, K) f32 plane read once,
    the (N, K) output written once; or one add per edge and column."""
    nbytes = (n + 1) * 4 + e * k * 4 + n * k * 4
    ops = e * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k10_bound(n: int, e: int, cb: int, h: int, f: int):
    """Least time for one K10 call: the dst of every slot (sentinels too, to
    skip them), the cols and (H,) weights of the e real slots, the f32 table
    once and the f32 output once; or 2 operations per real slot and column."""
    hf = h * f
    nbytes = cb * 4 + e * 4 + e * h * 4 + 2 * n * hf * 4
    ops = 2 * e * hf
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def k3_agreement(out, csr, vals, edge_block=None):
    """K3 against its plain version: (max_abs_err, worst err / sum|terms|,
    max |plain|)."""
    from stgraph_tpu_torch.ops.segment_kernels import segment_sum_narrow_plain

    ref = segment_sum_narrow_plain(csr, vals, edge_block)
    mass = segment_sum_narrow_plain(csr, vals.abs(), edge_block)
    return _stats([out], [ref], [mass])[0]


def k3_at_shape(csr, vals, where, iters, plain_iters):
    """K3 on a main path's (E, K) plane: within ``KERNEL_TOL`` of its plain
    version into a poisoned output and bit-equal over two calls, then timed
    beside the plain version, ``torch.segment_reduce`` and its bound, with
    the device time and launches of one call (``device_launches``)."""
    from stgraph_tpu_torch.ops import segment_kernels as SK

    n, e, k = csr.num_nodes, csr.num_edges, vals.shape[1]
    SK.segment_sum_narrow(csr, vals)  # the plan, built once
    out = poisoned_call((n, k), lambda: SK.segment_sum_narrow(csr, vals))
    check(torch.equal(out, SK.segment_sum_narrow(csr, vals)), f"K3 at {where} K={k} differs between two calls")
    a, r, _ = k3_agreement(out, csr, vals, 1 << 24)
    del out
    check(r <= KERNEL_TOL, f"K3 at {where} K={k} disagrees with its plain version: {r}")
    bound_ms, bound_by, nbytes, ops = k3_bound(n, e, k)
    ms = cuda_ms(lambda: SK.segment_sum_narrow(csr, vals), iters=iters, warmup=2)
    plain_ms = cuda_ms(lambda: SK.segment_sum_narrow_plain(csr, vals, 1 << 24), iters=plain_iters, warmup=1)
    lib_ms = _library_segment_sum_ms(csr, vals, e)
    launches = device_launches(lambda: SK.segment_sum_narrow(csr, vals), SK.segment_sum_narrow)
    print(f"k3-main {where} K={k}: N={n} E={e}: {ms:.4f} ms (plain {plain_ms:.2f} ms, segment_reduce {lib_ms} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by}), wrapper count {launches['wrapper_count_per_call']} a call "
          f"(device work {launches['device_work_per_call']} {launches['kernels_of_a_call']}, "
          f"{launches['device_ms_per_call']} ms); max_abs_err {a:.3e} (err/sum|terms| {r:.2e}), bit-equal over "
          f"two calls")
    return {"where": where, "H": k, "F": 1, "K": k, "E": e, "N": n, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library": "torch.segment_reduce(sum)", "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops, "max_abs_err": a, "err_over_mass": r, **launches}


def k10_agreement(out, blk, w, x, h, edge_block=COMPOSED_PLAIN_EDGE_BLOCK):
    """K10 against its plain version, as ``k3_agreement``."""
    from stgraph_tpu_torch.ops.spmm_blocked import segment_sum_blocked_plain

    ref = segment_sum_blocked_plain(blk, w, x, h, edge_block)
    err = (out - ref).abs()
    max_err, max_ref = err.max().item(), ref.abs().max().item()
    del out, ref  # the caller passes the kernel's output without keeping it
    mass = segment_sum_blocked_plain(blk, w.abs(), x.abs(), h, edge_block)
    return max_err, _err_over_mass(err, mass), max_ref


def check_graph(dev, rng, n, e, hub_deg):
    """The composed check graph: a hub of ``hub_deg`` edges in each
    direction, 1000 empty rows, ten empty 128-row blocks, padding slots."""
    from stgraph_tpu_torch.graph.csr import build_csr

    empty, hub = 1000, 12_345
    src = rng.integers(0, n - empty, e)
    dst = rng.integers(0, n - empty, e)
    b0 = n // 2 // 128 * 128
    dst = np.where((dst >= b0) & (dst < b0 + 10 * 128), 0, dst)  # ten empty row blocks
    dst[:hub_deg] = hub
    src[-hub_deg:] = hub + 1
    return build_csr(src, dst, n, capacity=e + 5, device=dev), empty


@timed_phase
def phase_composed_kernels_vs_plain(dev, rng, n=100_000, e=1_000_000, hub_deg=150_000):
    """K3 and K10 against their plain versions on a graph with a hub of
    ``hub_deg`` edges in each direction (so a 128-row block of each blocked
    layout holds more than 10^5 slots), 1000 empty rows, ten empty row
    blocks and padding slots: K3 at K in {1, 4, 6, 16} on the forward and
    transpose CSRs (bit-equal over two calls), K10 at (H, F) in
    ``COMPOSED_CHECKS`` on both blocked layouts, each into an output block
    poisoned with NaN (``poisoned_call``)."""
    from stgraph_tpu_torch.graph.blocked import build_blocked
    from stgraph_tpu_torch.ops.segment_kernels import segment_sum_narrow
    from stgraph_tpu_torch.ops.spmm_blocked import segment_sum_blocked

    csr, empty = check_graph(dev, rng, n, e, hub_deg)
    csr_t = csr.transpose()
    results, worst = [], {"K3": 0.0, "K10": 0.0}
    for name, c in (("forward", csr), ("transpose", csr_t)):
        for k in K3_CHECK_K:
            vals = torch.from_numpy(rng.standard_normal((c.capacity, k)).astype(np.float32)).to(dev)
            segment_sum_narrow(c, vals)  # the plan, built once
            out = poisoned_call((n, k), lambda: segment_sum_narrow(c, vals))
            check(torch.equal(out, segment_sum_narrow(c, vals)), f"K3 on the {name} CSR at K={k} differs between calls")
            a, r, mx = k3_agreement(out, c, vals)
            ok = r <= KERNEL_TOL and (name == "transpose" or not out[n - empty:].any().item())
            print(f"k3-check {name} CSR K={k}: max_abs_err {a:.3e} (err/sum|terms| {r:.2e}, max |plain| "
                  f"{mx:.2f}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K3 disagrees with its plain version on the {name} CSR at K={k}")
            worst["K3"] = max(worst["K3"], a)
            results.append({"kernel": "K3", "csr": name, "K": k, "max_abs_err": a, "err_over_mass": r})
        blk = build_blocked(c)
        slots = int(blk.counts.max().item())
        for h, f in COMPOSED_CHECKS:
            x = torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(dev)
            w = torch.from_numpy(rng.random((blk.capacity, h)).astype(np.float32)).to(dev)
            out = poisoned_call((n, h * f), lambda: segment_sum_blocked(blk, w, x, h))
            a, r, mx = k10_agreement(out, blk, w, x, h)
            ok = r <= KERNEL_TOL and (name == "transpose" or not out[n - empty:].any().item())
            print(f"k10-check {name} layout H={h} F={f} (largest block {slots} slots): max_abs_err {a:.3e} "
                  f"(err/sum|terms| {r:.2e}, max |plain| {mx:.2f}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K10 disagrees with its plain version on the {name} layout at H={h}, F={f}")
            worst["K10"] = max(worst["K10"], a)
            results.append({"kernel": "K10", "layout": name, "H": h, "F": f, "largest_block_slots": slots,
                            "max_abs_err": a, "err_over_mass": r})
            del x, w, out
        del blk
    return {"graph": {"n": n, "e": e, "empty_rows": empty, "hub_deg": hub_deg}, "cases": results,
            "max_abs_err": worst}


def gat_sampled_check(csr, layer, h_in, y, rows, elu, block=1 << 17):
    """Hold one composed GAT layer's output on ``rows`` against the softmax
    attention recomputed in f64 from the layer's input and weights: el and er
    from folded weights, the stability max, the weights and their sums, and
    the weighted rows gathered and projected in edge blocks. Returns
    (max_abs_err, worst err / sum|terms| (the softmax-weighted |rows|), max
    |ref|, edges checked)."""
    dev = y.device
    h, f = layer.num_heads, layer.out_feats
    wt = layer.fc.weight.double()  # (H*F, in)
    fold = wt.reshape(h, f, -1)
    al = (fold * layer.attn_l.double()[:, :, None]).sum(1)  # (H, in)
    ar = (fold * layer.attn_r.double()[:, :, None]).sum(1)
    indptr = csr.host_arrays()[0].astype(np.int64)
    deg = indptr[rows + 1] - indptr[rows]
    local_np = np.repeat(np.arange(len(rows)), deg)
    first = np.cumsum(deg) - deg
    eidx = indptr[rows][local_np] + (np.arange(deg.sum()) - first[local_np])
    cols = csr.cols[torch.from_numpy(eidx).to(dev)].long()
    local = torch.from_numpy(local_np).to(dev)
    rows_t = torch.from_numpy(rows).to(dev)
    er = h_in[rows_t].double() @ ar.T
    el = torch.cat([h_in[cols[b:b + block]].double() @ al.T for b in range(0, len(cols), block)])
    s = el + er[local]
    s = torch.where(s >= 0, s, GAT_SLOPE * s)
    m = torch.full((len(rows), h), float("-inf"), dtype=torch.float64, device=dev)
    m.scatter_reduce_(0, local[:, None].expand(-1, h), s, "amax")
    w = torch.exp(s - m[local])
    den = torch.zeros(len(rows), h, dtype=torch.float64, device=dev).index_add_(0, local, w)
    num = torch.zeros(len(rows), h * f, dtype=torch.float64, device=dev)
    mass = torch.zeros_like(num)
    for b in range(0, len(cols), block):
        fs = h_in[cols[b:b + block]].double() @ wt.T
        wb = w[b:b + block].repeat_interleave(f, 1)
        num.index_add_(0, local[b:b + block], fs * wb)
        mass.index_add_(0, local[b:b + block], fs.abs() * wb)
    scale = den.clamp(min=1e-300).repeat_interleave(f, 1)
    ref, mass = num / scale, mass / scale
    if elu:
        ref = torch.nn.functional.elu(ref)
    got = y[rows_t].reshape(len(rows), h * f).double()
    err = (got - ref).abs()
    ratio = (err / mass.clamp(min=1e-300)).masked_fill(err == 0, 0.0).max().item()
    return err.max().item(), ratio, ref.abs().max().item(), int(deg.sum())


@timed_phase
def phase_composed_ogbn_serving(dev, args, base):
    """The GAT at the GAT paper's PPI widths behind a ``Predictor`` on the
    full graph: 3 requests, each launching K4, K3 and K10 three times; each
    layer's output in the first request held against an f64 recomputation
    on sampled destination rows and the largest hub; then K3 and K10 at the
    first layer's shapes, with its own weights and features."""
    from stgraph_tpu_torch.ops.segment_kernels import segment_max_narrow
    from stgraph_tpu_torch.ops.spmm_blocked import _to_blocked_w_mh, segment_sum_blocked, segment_sum_blocked_plain
    from stgraph_tpu_torch.serve import Predictor

    graph, feats = base["graph"], base["feats"]
    csr = graph.fwd_csr
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    dims = (OGBN_FEATS, PPI_HIDDEN, OGBN_CLASSES)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = build_gat(graph, "auto", dev, args.seed, dims, PPI_HEADS)
    predictor = Predictor.build(model, dict(model.state_dict()), (feats,), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(args.seed + 7)
    deg = graph.in_degrees()
    rows = np.unique(np.concatenate([rng.choice(n, COMPOSED_SAMPLE_ROWS, replace=False), [int(deg.argmax())]]))
    checks = []

    def hook(layer, inp, out):
        i = len(checks)
        a, r, mx, edges = gat_sampled_check(csr, layer, inp[1], out, rows, elu=i < len(PPI_HEADS) - 1)
        ok = r <= KERNEL_TOL
        print(f"composed-serve-check layer {i} (H={layer.num_heads} F={layer.out_feats}): {len(rows)} rows incl. "
              f"hub of degree {int(deg.max())}, {edges} edges: max_abs_err {a:.3e} (max |ref| {mx:.2f}), "
              f"worst err/sum|terms| {r:.2e} (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
        checks.append({"layer": i, "max_abs_err": a, "err_over_mass": r, "max_abs_ref": mx, "ok": ok,
                       "rows": len(rows), "edges": edges})

    hooks = [layer.register_forward_hook(hook) for layer in model.layers]
    gen = torch.Generator(device=dev).manual_seed(args.seed + 5)
    requests = [feats] + [
        feats + 0.1 * torch.randn(feats.shape, device=dev, generator=gen) for _ in range(REQUESTS - 1)
    ]
    torch.cuda.synchronize()
    times, per_request = [], []
    reset_counts()
    for r, x in enumerate(requests):
        before = read_counts()
        t = time.perf_counter()
        logits = predictor(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if r == 0:
            for hk in hooks:
                hk.remove()
        delta = {k: v - before[k] for k, v in read_counts().items()}
        per_request.append(delta)
        check(delta == only(K3=3, K4=3, K10=3),
              f"composed GAT request {r} launched {delta}, expected K3, K4 and K10 three times each")
        check(tuple(logits.shape) == (n, OGBN_CLASSES), f"composed GAT logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all().item()), f"composed GAT request {r}: non-finite logits")
    counts = read_counts()
    check(all(c["ok"] for c in checks) and len(checks) == len(PPI_HEADS),
          "a composed GAT layer disagrees with its f64 recomputation")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"composed-serve: GAT {dims[0]} -> {PPI_HEADS[0]}x{PPI_HIDDEN} -> {PPI_HEADS[1]}x{PPI_HIDDEN} -> "
          f"{PPI_HEADS[2]}x{OGBN_CLASSES} (mean) on N={n} E={e}: model+Predictor.build (warm call, blocked "
          f"layouts) {build_s:.2f} s; {REQUESTS} requests, launches {counts}, per-request s "
          f"{[round(v, 4) for v in times]}, peak device memory {peak_gb:.2f} GB")
    del requests, logits
    profile = phase_profile(lambda: predictor(feats), "one composed GAT request")
    del predictor

    # K3 and K10 at the first layer's shapes, with its own weights and features
    blocked = graph.blocked_fwd
    layer = model.layers[0]
    h, f = layer.num_heads, layer.out_feats
    main = {}
    with torch.inference_mode():
        fs = layer.fc(feats)
        el = (fs.reshape(n, h, f) * layer.attn_l).sum(-1)
        er = (fs.reshape(n, h, f) * layer.attn_r).sum(-1)
        rows_c, cols_c = csr.rows_clamped.long(), csr.cols_clamped.long()
        s0 = el[cols_c] + er[rows_c]
        del el, er
        s = torch.where(s0 >= 0, s0, GAT_SLOPE * s0)
        del s0
        m = segment_max_narrow(csr, s)
        w = torch.where(csr.edge_mask[:, None], torch.exp(s - m[rows_c]), torch.zeros((), device=dev))
        del s, m, rows_c, cols_c
        main["K3"] = k3_at_shape(csr, w, "ogbn forward", iters=10, plain_iters=1)
        a3 = main["K3"]["max_abs_err"]
        k10_lib_heads = _library_multihead_ms(csr, w, fs, h, e)
        k10_lib = _library_blockdiag_ms(csr, w, fs, h, e)
        wb = _to_blocked_w_mh(blocked, csr, w)
        del w
        a10, r10, _ = k10_agreement(segment_sum_blocked(blocked, wb, fs, h), blocked, wb, fs, h)
        check(r10 <= KERNEL_TOL, f"K10 at ogbn-products shape disagrees: {r10}")
        k10_ms = cuda_ms(lambda: segment_sum_blocked(blocked, wb, fs, h), iters=5, warmup=1)
        k10_plain = cuda_ms(lambda: segment_sum_blocked_plain(blocked, wb, fs, h, COMPOSED_PLAIN_EDGE_BLOCK),
                            iters=1, warmup=0)
        del wb
        b10 = k10_bound(n, e, blocked.capacity, h, f)
        print(f"k10-ogbn H={h} F={f}: {k10_ms:.3f} ms (plain {k10_plain:.1f} ms, one block-diagonal sparse.mm "
              f"{k10_lib} ms, {h} x sparse.mm {k10_lib_heads} ms, "
              f"bound {b10[0]:.3f} ms by {b10[1]}); full-graph max_abs_err {a10:.3e} (err/sum|terms| {r10:.2e}); "
              f"gathered rows {e * h * f * 4 / 1e9:.1f} GB, {e * h * f * 4 / (k10_ms * 1e-3) / 1e12:.2f} TB/s")
        main["K10"] = {"H": h, "F": f, "E": e, "N": n, "CB": blocked.capacity, "ms": k10_ms, "plain_ms": k10_plain,
                       "library_ms": k10_lib, "library_heads_ms": k10_lib_heads, "bound_ms": b10[0], "bound_by": b10[1], "bytes": b10[2],
                       "ops": b10[3], "max_abs_err": a10, "err_over_mass": r10}
        del fs
    del model
    torch.cuda.empty_cache()
    return {"counts": counts, "main": main, "max_abs_err": {"K3": a3, "K10": a10},
            "record": {"build_s": build_s, "request_s": times, "launches": counts,
                       "launches_per_request": per_request, "sampled_checks": checks,
                       "peak_device_memory_gb": peak_gb, "max_in_degree": int(deg.max()), "main": main,
                       "profile": profile}}


def _library_segment_sum_ms(csr, vals, e, reduce="sum"):
    """``torch.segment_reduce`` (``sum`` or ``max``) over the CSR-order
    (E, K) plane: a timed yardstick only."""
    try:
        plane = vals[:e]
        offsets = csr.indptr.long()
        return cuda_ms(lambda: torch.segment_reduce(plane, reduce, offsets=offsets, unsafe=True), iters=5)
    except (RuntimeError, TypeError) as exc:
        print(f"library yardstick segment_reduce({reduce}) unavailable: {exc}")
        return None


def _library_multihead_ms(csr, w, x, h, e):
    """H calls of ``torch.sparse.mm``, one a head, with that head's weights on
    the CSR's pattern and that head's columns of ``x``: a timed yardstick
    only (the column copies are not timed)."""
    try:
        n = csr.num_nodes
        f = x.shape[1] // h
        total = 0.0
        for k in range(h):
            a = torch.sparse_csr_tensor(csr.indptr, csr.cols[:e], w[:e, k].contiguous(), size=(n, n),
                                        check_invariants=False)
            xk = x[:, k * f:(k + 1) * f].contiguous()
            total += cuda_ms(lambda: torch.sparse.mm(a, xk), iters=3)
            del a, xk
        return total
    except (RuntimeError, TypeError) as exc:
        print(f"library yardstick sparse.mm unavailable: {exc}")
        return None


def blockdiag_by_head(csr, w, h, e):
    """The (N*H, N*H) CSR matrix whose row ``d*H + k`` holds, for each real
    edge ``s -> d``, the value ``w[edge, k]`` at column ``s*H + k``: one
    ``torch.sparse.mm`` of it against ``x.view(N*H, F)`` computes the
    multi-head weighted sum ``out[d, k*F:(k+1)*F] = sum w[edge, k] *
    x[s, k*F:(k+1)*F]`` in a single call. Int32 indices."""
    n, dev = csr.num_nodes, csr.device
    indptr = csr.indptr.long()
    deg = indptr[1:] - indptr[:-1]
    k = torch.arange(h, device=dev)
    crow = torch.empty(n * h + 1, dtype=torch.int64, device=dev)
    crow[:-1] = ((h * indptr[:-1])[:, None] + k[None, :] * deg[:, None]).reshape(-1)
    crow[-1] = h * e
    rows = csr.rows[:e].long()
    start = indptr[rows]
    pos = (h * start + torch.arange(e, device=dev) - start)[:, None] + k[None, :] * deg[rows][:, None]
    del start
    pos = pos.reshape(-1)
    col2 = torch.empty(e * h, dtype=torch.int32, device=dev)
    col2[pos] = (csr.cols[:e].long()[:, None] * h + k[None, :]).reshape(-1).int()
    val2 = torch.empty(e * h, dtype=torch.float32, device=dev)
    val2[pos] = w[:e].reshape(-1).float()
    del pos, rows
    return torch.sparse_csr_tensor(crow.int(), col2, val2, size=(n * h, n * h), check_invariants=False)


def _library_blockdiag_ms(csr, w, x, h, e, iters=3):
    """One ``torch.sparse.mm`` over ``blockdiag_by_head`` against the free
    view ``x.view(N*H, F)``: the single library call that computes K10's
    (and K1's heads mode's) function, a timed yardstick only (building the
    pattern is not timed). None, printed as unavailable, where it cannot run
    (out of memory at ogbn-products size)."""
    try:
        n = csr.num_nodes
        a = blockdiag_by_head(csr, w, h, e)
        xv = x.float().reshape(n * h, x.shape[1] // h)
        ms = cuda_ms(lambda: torch.sparse.mm(a, xv), iters=iters)
        del a, xv
        return ms
    except (RuntimeError, TypeError) as exc:  # torch.cuda.OutOfMemoryError is a RuntimeError
        print(f"library yardstick sparse.mm (one call, block-diagonal by head) unavailable: {exc}")
        torch.cuda.empty_cache()
        return None


def ppi_graph(dev, seed):
    """A graph of the GAT paper's PPI size (Table 1: 56,944 nodes, 818,716
    edges, 50 features, 121 labels), synthesised as the ogbn-products
    stand-in is (Chung-Lu degrees, communities, labels following them)."""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph

    edge_index, feat, labels = OgbNodeDataLoader._synthesize(PPI_NODES, PPI_EDGES, PPI_FEATS, PPI_CLASSES, 1.0, seed)
    graph = StaticGraph(edge_index.T, None, PPI_NODES, device=dev)
    return graph, torch.from_numpy(feat).to(dev), torch.from_numpy(labels).to(dev)


@timed_phase
def phase_ppi_gat(dev, args):
    """The GAT paper's PPI model (``benchmarking/gat/train.py --num_layers 3
    --num_hidden 256 --num_heads 4 --num_out_heads 6``) on a PPI-sized graph:
    3 requests behind a ``Predictor`` (3 K4, 3 K3 and 3 K10 each), then
    1 + 5 Adam(5e-3) steps (3 K4, 9 K3 and 6 K10 each), then the logits and
    one step's gradients against the vertex program with K3's and K4's
    plain versions."""
    from stgraph_tpu_torch.serve import Predictor

    t = time.perf_counter()
    graph, x, y = ppi_graph(dev, args.seed)
    n, e = graph.get_num_nodes(), graph.get_num_edges()
    _ = graph.blocked_fwd, graph.blocked_bwd
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    model = build_gat(graph, "auto", dev, args.seed, PPI_DIMS, PPI_HEADS)
    predictor = Predictor.build(model, dict(model.state_dict()), (x,), device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    requests = [x] + [x + 0.1 * torch.randn(x.shape, device=dev, generator=gen) for _ in range(REQUESTS - 1)]
    torch.cuda.synchronize()
    times, per_request = [], []
    reset_counts()
    for r, xr in enumerate(requests):
        before = read_counts()
        t = time.perf_counter()
        logits = predictor(xr)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        delta = {k: v - before[k] for k, v in read_counts().items()}
        per_request.append(delta)
        check(delta == only(K3=3, K4=3, K10=3), f"PPI request {r} launched {delta}, expected K3, K4, K10 x3")
        check(tuple(logits.shape) == (n, PPI_CLASSES), f"PPI logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all().item()), f"PPI request {r}: non-finite logits")
    serve_counts = read_counts()
    print(f"ppi-serve: synthetic PPI N={n} E={e} (graph, CSRs and blocked layouts {setup_s:.2f} s); GAT "
          f"{PPI_DIMS[0]} -> {PPI_HEADS[0]}x{PPI_HIDDEN} -> {PPI_HEADS[1]}x{PPI_HIDDEN} -> {PPI_HEADS[2]}x"
          f"{PPI_CLASSES} (mean): {REQUESTS} requests, launches {serve_counts}, per-request s "
          f"{[round(v, 5) for v in times]}")
    served_logits = predictor(x)
    del predictor, requests

    tmodel = build_gat(graph, "auto", dev, args.seed, PPI_DIMS, PPI_HEADS).train()
    opt = torch.optim.Adam(tmodel.parameters(), lr=5e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(tmodel(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss.item()

    t = time.perf_counter()
    warm_loss = step()
    warm_s = time.perf_counter() - t
    losses, step_s, per_step = [], [], []
    reset_counts()
    for _ in range(TRAIN_STEPS):
        before = read_counts()
        t = time.perf_counter()
        losses.append(step())
        step_s.append(time.perf_counter() - t)
        per_step.append({k: v - before[k] for k, v in read_counts().items()})
    train_counts = read_counts()
    print(f"ppi-train: warm step {warm_s:.3f} s (loss {warm_loss:.4f}); {TRAIN_STEPS} Adam steps, s per step "
          f"{[round(v, 4) for v in step_s]}, losses {[round(v, 4) for v in losses]}, launches {train_counts}")
    check(all(c == only(K3=9, K4=3, K10=6) for c in per_step),
          f"a PPI training step launched {per_step}, expected K3 x9, K4 x3, K10 x6")
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), "non-finite PPI training loss")
    check(losses[-1] < losses[0], f"the PPI loss did not fall over {TRAIN_STEPS} steps: {losses}")
    profile = phase_profile(step, "one PPI GAT training step")
    del tmodel, opt

    # the same model's logits and one step's gradients on the vertex program
    grads = {}
    for impl in ("auto", "torch"):
        m = build_gat(graph, impl, dev, args.seed, PPI_DIMS, PPI_HEADS)
        plain = impl == "torch"
        with plain_narrow_kernels() if plain else contextlib.nullcontext(), \
                plain_wide_kernels() if plain else contextlib.nullcontext():
            out = m(x)
            torch.nn.functional.cross_entropy(out, y).backward()
        if impl == "torch":
            plain_logits = out.detach()
        grads[impl] = {k: p.grad for k, p in m.named_parameters()}
        del m, out
    scale = plain_logits.abs().max().item()
    err = (served_logits - plain_logits).abs().max().item()
    ok = err <= COMPOSED_LOGIT_TOL * scale
    print(f"ppi-model-check: served logits vs the vertex program (K3/K4 plain) max_abs_err {err:.3e} "
          f"(max |plain| {scale:.3f}, tol {COMPOSED_LOGIT_TOL:g} x that) {'ok' if ok else 'FAIL'}")
    check(ok, "the PPI GAT's served logits disagree with the plain path")
    rows, worst = [], 0.0
    for k, ref in grads["torch"].items():
        gerr = (grads["auto"][k] - ref).abs().max().item()
        ratio = gerr / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        rows.append({"tensor": k, "max_abs_err": gerr, "err_over_max": ratio})
    print(f"ppi-grad-check: {len(rows)} parameter gradients, composed route vs the vertex program, worst "
          f"max_abs_err / max |plain| {worst:.2e} (tol {COMPOSED_GRAD_TOL:g}) "
          f"{'ok' if worst <= COMPOSED_GRAD_TOL else 'FAIL'}")
    check(worst <= COMPOSED_GRAD_TOL, f"a PPI GAT gradient disagrees with the plain path: {rows}")
    return {"graph": graph, "x": x,
            "serve_counts": serve_counts, "train_counts": train_counts,
            "record": {"n": n, "e": e, "setup_s": setup_s, "request_s": times, "launches_per_request": per_request,
                       "serve_launches": serve_counts, "warm_s": warm_s, "warm_loss": warm_loss, "step_s": step_s,
                       "losses": losses, "launches_per_step": per_step, "train_launches": train_counts,
                       "profile": profile, "logit_err": err, "max_abs_plain_logit": scale, "grads": rows,
                       "worst_grad_err_over_max": worst}}


@timed_phase
def phase_composed_at_main_shapes(dev, ppi):
    """K3 and K10 at a PPI training step's shapes: K3 at K = 4 and 6 on the
    forward and transpose CSRs (``k3_at_shape``), K10 at 4 x 256 and 6 x 121
    on both blocked layouts; random positive weights, random features. Each
    kernel, its plain version and a library call timed, full outputs
    compared. Returns per-launch records in the order of one training
    step's launches, and K3's records by shape."""
    from stgraph_tpu_torch.ops.spmm_blocked import positions_in, segment_sum_blocked, segment_sum_blocked_plain

    graph = ppi["graph"]
    csr, csr_t = graph.fwd_csr, graph.bwd_csr
    n = csr.num_nodes
    e = int(csr.host_arrays()[0][-1])
    gen = torch.Generator(device=dev).manual_seed(13)
    k3, k10, worst = {}, {}, {"K3": 0.0, "K10": 0.0}
    with torch.inference_mode():
        for name, c in (("forward", csr), ("transpose", csr_t)):
            for k in sorted({PPI_HEADS[0], PPI_HEADS[-1]}):
                vals = torch.rand(c.capacity, k, device=dev, generator=gen)
                k3[(name, k)] = dict(k3_at_shape(c, vals, f"ppi {name}", iters=20, plain_iters=3), csr=name)
                worst["K3"] = max(worst["K3"], k3[(name, k)]["max_abs_err"])
                del vals
        for name, c in (("forward", csr), ("transpose", csr_t)):
            blk = graph.blocked_fwd if name == "forward" else graph.blocked_bwd
            for h, f in ((PPI_HEADS[0], PPI_HIDDEN), (PPI_HEADS[-1], PPI_CLASSES)):
                x = torch.randn(n, h * f, device=dev, generator=gen)
                w = torch.rand(c.capacity, h, device=dev, generator=gen)
                # the weights in the layout's slot order, as the route routes them (by user edge id)
                wb = w.index_select(0, positions_in(c, blk.eids))
                out = poisoned_call((n, h * f), lambda: segment_sum_blocked(blk, wb, x, h))
                a, r, _ = k10_agreement(out, blk, wb, x, h)
                del out
                check(r <= KERNEL_TOL, f"K10 at the PPI shape ({name}, H={h}, F={f}) disagrees: {r}")
                ms = cuda_ms(lambda: segment_sum_blocked(blk, wb, x, h), iters=20, warmup=2)
                plain_ms = cuda_ms(lambda: segment_sum_blocked_plain(blk, wb, x, h, COMPOSED_PLAIN_EDGE_BLOCK),
                                   iters=2, warmup=1)
                lib = _library_blockdiag_ms(c, w, x, h, e, iters=10)
                lib_heads = _library_multihead_ms(c, w, x, h, e)
                b = k10_bound(n, e, blk.capacity, h, f)
                print(f"k10-main {name} layout H={h} F={f}: {ms:.4f} ms (plain {plain_ms:.2f} ms, one block-diagonal "
                      f"sparse.mm {lib} ms, {h} x sparse.mm {lib_heads} ms, bound {b[0]:.4f} ms by {b[1]}); "
                      f"max_abs_err {a:.3e} (err/sum|terms| {r:.2e})")
                worst["K10"] = max(worst["K10"], a)
                k10[(name, h)] = {"layout": name, "H": h, "F": f, "E": e, "N": n, "CB": blk.capacity, "ms": ms,
                                  "plain_ms": plain_ms, "library_ms": lib, "library_heads_ms": lib_heads,
                                  "bound_ms": b[0], "bound_by": b[1],
                                  "bytes": b[2], "ops": b[3], "max_abs_err": a, "err_over_mass": r}
                del x, w, wb
    h0, h2 = PPI_HEADS[0], PPI_HEADS[-1]
    # one training step: the denominators (forward CSR), d er (forward CSR), d el (transpose CSR);
    # K10 forward on the forward layout, d feat on the transpose layout
    k3_step = [k3[("forward", hh)] for hh in (h0, h0, h2)] * 2 + [k3[("transpose", hh)] for hh in (h0, h0, h2)]
    k10_step = [k10[(name, hh)] for name in ("forward", "transpose") for hh in (h0, h0, h2)]
    return {"K3": k3_step, "K10": k10_step,
            "K3_by_shape": {f"ppi {name} K={k}": rec for (name, k), rec in k3.items()}}, worst


# -- the composed route's rowmask branch: K5, K1's no-gather and heads modes, K2's heads mode --


def wide_bound(n: int, e: int, k: int):
    """Least time for one K5 or no-gather call: indptr and the (E, K) f32
    plane read once, the (N, K) output written once; or one operation per
    edge and column."""
    nbytes = (n + 1) * 4 + e * k * 4 + n * k * 4
    ops = e * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def rowmask_bound(n: int, e: int, h: int, f: int):
    """Least time for one K1 call with H heads and the denominator: indptr,
    cols and the (E, H) weights, the f32 (N, H*F) table once, the output and
    the (N, H) denominator once; or 2 operations per edge and column plus one
    per edge and head."""
    hf = h * f
    nbytes = (n + 1) * 4 + e * 4 + e * h * 4 + 2 * n * hf * 4 + n * h * 4
    ops = 2 * e * hf + e * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def rowmask_bwd_bound(n: int, e: int, h: int, f: int):
    """Least time for one K2 call with H heads: indptr, cols, the (E, H)
    weights and dw once each, the f32 g and fs tables read once, dh written
    once; or 4 operations per edge and column."""
    hf = h * f
    nbytes = (n + 1) * 4 + e * 4 + 2 * e * h * 4 + 3 * n * hf * 4
    ops = 4 * e * hf
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def longest_item(csr, chunk=None) -> int:
    """The most edges one warp walks in a launch over ``csr`` whose work
    items cap a row at ``chunk`` edges (default ``ROW_CHUNK``, the first
    designs' items; K1's modes take ``K1_CHUNK``, K2's ``K2_CHUNK``, K3
    ``K3_CHUNK``, K4 ``K4_CHUNK``, K5 ``K5_CHUNK``, K8 and K9
    ``FLASH_CHUNK``)."""
    from stgraph_tpu_torch.ops.spmm_kernels import ROW_CHUNK

    return int(min(np.diff(csr.host_arrays()[0]).max(initial=0), chunk or ROW_CHUNK))


@contextlib.contextmanager
def wide_stream(bf16: bool):
    """Inside, the no-gather sum streams bf16 exactly when ``bf16`` (its rule
    would decide from the graph's size)."""
    from stgraph_tpu_torch.ops import segment_kernels as SK

    saved = SK.WIDE_BF16_MIN_SLOTS
    SK.WIDE_BF16_MIN_SLOTS = 0 if bf16 else 2**62
    try:
        yield
    finally:
        SK.WIDE_BF16_MIN_SLOTS = saved


@timed_phase
def phase_rowmask_kernels_vs_plain(dev, rng, n=100_000, e=1_000_000, hub_deg=150_000):
    """K5, K1's no-gather mode, K1's heads and denominator modes and K2's
    heads mode against their plain versions on the composed check graph:
    K5 (bit for bit) and the no-gather sum (f32 and bf16 streams) at K in
    {17, 32, 130} on the forward and transpose CSRs; K1 with heads and the
    denominator on the forward CSR and K2 with heads on the transpose, at
    (H, F) in {(32, 4), (8, 64), (4, 128), (64, 2), (1, 384)}, each with
    the f32 and the bf16 stream."""
    from stgraph_tpu_torch.ops.segment_kernels import (
        segment_max_wide,
        segment_max_wide_plain,
        segment_sum_wide,
        segment_sum_wide_plain,
    )
    from stgraph_tpu_torch.ops.spmm_kernels import (
        spmm_rowmask,
        spmm_rowmask_bwd,
        spmm_rowmask_bwd_plain,
        spmm_rowmask_plain,
    )

    csr, empty = check_graph(dev, rng, n, e, hub_deg)
    csr_t = csr.transpose()
    block = COMPOSED_PLAIN_EDGE_BLOCK
    results, worst = [], {"K5": 0.0, "K1_nogather": 0.0, "K1": 0.0, "K2": 0.0}
    for name, c in (("forward", csr), ("transpose", csr_t)):
        for k in WIDE_CHECK_K:
            vals = torch.from_numpy(rng.standard_normal((c.capacity, k)).astype(np.float32)).to(dev)
            out = segment_max_wide(c, vals)
            torch.cuda.synchronize()
            ok = torch.equal(out, segment_max_wide_plain(c, vals, block)) and (
                name == "transpose" or not out[n - empty:].any().item())
            print(f"k5-check {name} CSR K={k}: bit-equal to its plain version {'ok' if ok else 'FAIL'}")
            check(ok, f"K5 differs from its plain version on the {name} CSR at K={k}")
            results.append({"kernel": "K5", "csr": name, "K": k, "bit_equal": ok})
            for bf16 in (False, True):
                with wide_stream(bf16):
                    out = poisoned_call((c.num_nodes, k), lambda: segment_sum_wide(c, vals))
                    torch.cuda.synchronize()
                    (a, r, mx), = _stats([out], [segment_sum_wide_plain(c, vals, block)],
                                         [segment_sum_wide_plain(c, vals.abs(), block)])
                stream = "bf16" if bf16 else "f32"
                ok = r <= KERNEL_TOL and (name == "transpose" or not out[n - empty:].any().item())
                print(f"k1-nogather-check {name} CSR K={k} {stream}: max_abs_err {a:.3e} (err/sum|terms| "
                      f"{r:.2e}, max |plain| {mx:.2f}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"the no-gather sum disagrees with its plain version ({name}, K={k}, {stream})")
                worst["K1_nogather"] = max(worst["K1_nogather"], a)
                results.append({"kernel": "K1_nogather", "csr": name, "K": k, "stream": stream,
                                "max_abs_err": a, "err_over_mass": r})
            del vals, out
    for h, f in ROWMASK_CHECKS:
        x, g = (torch.from_numpy(rng.standard_normal((n, h * f)).astype(np.float32)).to(dev) for _ in range(2))
        w = torch.from_numpy(rng.random((csr.capacity, h)).astype(np.float32)).to(dev)  # softmax weights: >= 0
        for stream in (None, torch.bfloat16):
            sname = "bf16" if stream is not None else "f32"
            out, den = poisoned_call((n, h * f), lambda: spmm_rowmask(csr, w, x, heads=h, with_denom=True,
                                                                      stream_dtype=stream))
            torch.cuda.synchronize()
            ref, ref_den = spmm_rowmask_plain(csr, w, x, stream, block, heads=h, with_denom=True)
            mass = spmm_rowmask_plain(csr, w, x.abs(), stream, block, heads=h)
            (a, r, _), (da, dr, _) = _stats([out, den], [ref, ref_den], [mass, ref_den])
            ok = max(r, dr) <= KERNEL_TOL and not out[n - empty:].any().item() and not den[n - empty:].any().item()
            print(f"k1-heads-check {h} x {f} {sname}: out max_abs_err {a:.3e} (err/sum|terms| {r:.2e}), "
                  f"den max_abs_err {da:.3e} ({dr:.2e}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K1 with heads and the denominator disagrees at {h} x {f}, {sname} stream")
            del out, den, ref, ref_den, mass
            dh, dw = poisoned_k2_call((n, h * f), (csr_t.capacity, h), lambda: spmm_rowmask_bwd(
                csr_t, w, g, x, stream_dtype=stream, heads=h))
            torch.cuda.synchronize()
            refs = spmm_rowmask_bwd_plain(csr_t, w, g, x, stream, block, heads=h)
            masses = spmm_rowmask_bwd_plain(csr_t, w, g.abs(), x.abs(), stream, block, heads=h)
            (ha, hr, _), (wa, wr, _) = _stats([dh, dw], refs, masses)
            pad_zero = not dw[csr_t.num_edges:].any().item()
            ok = max(hr, wr) <= KERNEL_TOL and pad_zero
            print(f"k2-heads-check {h} x {f} {sname}: dh max_abs_err {ha:.3e} (err/sum|terms| {hr:.2e}), dw "
                  f"max_abs_err {wa:.3e} ({wr:.2e}), padding 0 {pad_zero} (tol {KERNEL_TOL:g}) "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K2 with heads disagrees at {h} x {f}, {sname} stream")
            del dh, dw, refs, masses
            worst["K1"] = max(worst["K1"], a, da)
            worst["K2"] = max(worst["K2"], ha, wa)
            results.append({"kernel": "K1+K2", "H": h, "F": f, "stream": sname, "out_err_over_mass": r,
                            "den_err_over_mass": dr, "dh_err_over_mass": hr, "dw_err_over_mass": wr})
        del x, g, w
    return {"graph": {"n": n, "e": e, "empty_rows": empty, "hub_deg": hub_deg,
                      "longest_item": {"forward": longest_item(csr), "transpose": longest_item(csr_t)}},
            "cases": results, "max_abs_err": worst}


@timed_phase
def phase_pubmed_rowmask(dev, args, workdir):
    """``benchmarking/gat/train.py --dataset pubmed --num_heads 32
    --num_hidden 4`` on the port: 500 -> 32 x 4 (ELU, heads concatenated)
    -> 1 x 3, Adam(5e-3), 200 full-graph epochs. The 32 x 4 layer takes the
    composed route's rowmask branch (88,648 edges: an f32 stream): K5 and
    K1 with heads and the denominator forward, K2 with heads and the
    no-gather sum twice backward; the 1 x 3 layer the flash route (K4, K8;
    K9). Then one step's logits and gradients against the vertex program
    with every kernel's plain version."""
    from stgraph_tpu_torch.dataset import PubmedDataLoader, STGraphDataset
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.utils import accuracy

    STGraphDataset._offline = True  # no network here: the synthetic Pubmed, without a download attempt
    pubmed = PubmedDataLoader(cache_dir=os.path.join(workdir, "datasets"))
    n = pubmed.gdata["num_nodes"]
    graph = StaticGraph(pubmed.get_edges(), None, n, device=dev)
    x = torch.from_numpy(pubmed.get_all_features()).to(dev)
    y = torch.from_numpy(pubmed.get_all_targets()).to(dev)
    gen = torch.Generator().manual_seed(args.seed)  # drawn on the CPU, as phase_pubmed_gat's
    model = GAT(graph, PUBMED_ROWMASK_DIMS, PUBMED_ROWMASK_HEADS, "auto", torch.device("cpu"), gen).to(dev).train()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = torch.nn.functional.cross_entropy(model(x), y)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        return loss

    reset_counts()
    times = []
    for epoch in range(PUBMED_EPOCHS):
        t = time.perf_counter()
        loss = step()
        if epoch >= 3:
            times.append(time.perf_counter() - t)
    counts = read_counts()
    with torch.inference_mode():
        acc = accuracy(model(x), y)
    epoch_s = float(np.mean(times))
    print(f"pubmed-rowmask: synthetic={pubmed.synthetic} N={n} E={pubmed.gdata['num_edges']}, GAT "
          f"{PUBMED_ROWMASK_DIMS[0]} -> {PUBMED_ROWMASK_HEADS[0]}x{PUBMED_ROWMASK_DIMS[1]} -> "
          f"{PUBMED_ROWMASK_HEADS[1]}x{PUBMED_ROWMASK_DIMS[2]}, {PUBMED_EPOCHS} epochs, mean epoch (>=3) "
          f"{epoch_s * 1e3:.3f} ms, final loss {loss.item():.4f}, train acc {acc:.4f} (floor "
          f"{PUBMED_ROWMASK_ACC_FLOOR:.4f}), launches {counts}")
    ep = PUBMED_EPOCHS
    check(counts == only(K1=ep, K2=ep, K4=ep, K5=ep, K1_nogather=2 * ep, K8=ep, K9=ep),
          f"the Pubmed rowmask GAT launched {counts}")
    check(acc >= PUBMED_ROWMASK_ACC_FLOOR,
          f"Pubmed rowmask GAT train accuracy {acc:.4f} is below {PUBMED_ROWMASK_ACC_FLOOR:.4f}")
    profile = phase_profile(step, "one Pubmed rowmask epoch")  # after the counts and the accuracy
    del model, opt
    with torch.inference_mode():  # K5 at this path's shape: (E, 32) scores on the Pubmed CSR
        csr = graph.fwd_csr
        k5 = k5_at_shape(csr, torch.randn(csr.capacity, PUBMED_ROWMASK_HEADS[0], device=dev,
                                          generator=torch.Generator(device=dev).manual_seed(args.seed + 23)), "pubmed")

    logits, grads = {}, {}
    for impl in ("auto", "torch"):
        m = build_gat(graph, impl, dev, args.seed, PUBMED_ROWMASK_DIMS, PUBMED_ROWMASK_HEADS)
        plain = impl == "torch"
        with plain_narrow_kernels() if plain else contextlib.nullcontext(), \
                plain_wide_kernels() if plain else contextlib.nullcontext():
            out = m(x)
            torch.nn.functional.cross_entropy(out, y).backward()
        logits[impl] = out.detach()
        grads[impl] = {k: p.grad for k, p in m.named_parameters()}
        del m, out
    scale = logits["torch"].abs().max().item()
    err = (logits["auto"] - logits["torch"]).abs().max().item()
    ok = err <= COMPOSED_LOGIT_TOL * scale
    print(f"pubmed-rowmask-check: logits vs the vertex program (plain kernels) max_abs_err {err:.3e} "
          f"(max |plain| {scale:.3f}, tol {COMPOSED_LOGIT_TOL:g} x that) {'ok' if ok else 'FAIL'}")
    check(ok, "the Pubmed rowmask GAT's logits disagree with the vertex program")
    rows, worst = [], 0.0
    for k, ref in grads["torch"].items():
        gerr = (grads["auto"][k] - ref).abs().max().item()
        ratio = gerr / max(ref.abs().max().item(), 1e-30)
        worst = max(worst, ratio)
        rows.append({"tensor": k, "max_abs_err": gerr, "err_over_max": ratio})
    print(f"pubmed-rowmask-grad-check: {len(rows)} parameter gradients vs the vertex program, worst "
          f"max_abs_err / max |plain| {worst:.2e} (tol {COMPOSED_GRAD_TOL:g}) "
          f"{'ok' if worst <= COMPOSED_GRAD_TOL else 'FAIL'}")
    check(worst <= COMPOSED_GRAD_TOL, f"a Pubmed rowmask GAT gradient disagrees with the vertex program: {rows}")
    return {"synthetic": pubmed.synthetic, "n": n, "e": pubmed.gdata["num_edges"], "epoch_s": epoch_s,
            "train_acc": acc, "loss": loss.item(), "launches": counts, "profile": profile, "logit_err": err,
            "max_abs_plain_logit": scale, "grads": rows, "worst_grad_err_over_max": worst, "k5": k5}


def rowmask_reference(csr, el, er, fs, g, slope):
    """The softmax attention and its three gradients in f64 by autograd, on
    the edge list (the stability max detached: the softmax does not depend on
    it), with each output's sum of absolute terms. Returns (out, d el, d er,
    d feat) and their masses, all f64."""
    n, h, f = fs.shape
    e = csr.num_edges
    rows, cols = csr.rows[:e].long(), csr.cols[:e].long()
    el64, er64, fs64 = (t.double().requires_grad_() for t in (el, er, fs))
    s0 = el64[cols] + er64[rows]
    s = torch.where(s0 >= 0, s0, slope * s0)
    m = torch.full((n, h), float("-inf"), dtype=torch.float64, device=el.device)
    m = m.scatter_reduce(0, rows[:, None].expand(-1, h), s.detach(), "amax", include_self=True)
    w = torch.exp(s - m[rows])
    den = torch.zeros(n, h, dtype=torch.float64, device=el.device).index_add(0, rows, w)
    alpha = w / den[rows]
    out = torch.zeros(n, h, f, dtype=torch.float64, device=el.device).index_add(
        0, rows, alpha[:, :, None] * fs64[cols])
    g64 = g.double()
    d_el, d_er, d_fs = torch.autograd.grad((out * g64).sum(), (el64, er64, fs64))
    with torch.no_grad():
        zeros = torch.zeros(n, h, f, dtype=torch.float64, device=el.device)
        a = alpha.detach()
        mass_out = zeros.index_add(0, rows, a[:, :, None] * fs64[cols].abs())
        mass_fs = zeros.index_add(0, cols, a[:, :, None] * g64[rows].abs())
        # the route forms c = <g, out> / den from its own output, so c's terms
        # are |g_f| times out's (mass_out), not |<g, out>|
        c_terms = (g64.abs() * mass_out).sum(-1)
        slope_e = torch.where(s0.detach() >= 0, 1.0, slope).double()
        term = a * ((fs64[cols] * g64[rows]).abs().sum(-1) + c_terms[rows]) * slope_e
        mass_el = torch.zeros(n, h, dtype=torch.float64, device=el.device).index_add(0, cols, term)
        mass_er = torch.zeros(n, h, dtype=torch.float64, device=el.device).index_add(0, rows, term)
    return (out.detach(), d_el, d_er, d_fs), (mass_out, mass_el, mass_er, mass_fs)


def _library_multihead_bwd_ms(csr_t, w_t, g, fs, h, e):
    """Per head, ``torch.sparse.mm`` of the head's weights on the transpose
    pattern with the head's cotangent columns, and
    ``torch.sparse.sampled_addmm`` of the head's features and cotangents on
    that pattern: K2's two results from library calls, a timed yardstick
    only (the column copies are not timed)."""
    try:
        n = csr_t.num_nodes
        f = g.shape[1] // h
        total = 0.0
        for k in range(h):
            a = torch.sparse_csr_tensor(csr_t.indptr, csr_t.cols[:e], w_t[:e, k].contiguous(), size=(n, n),
                                        check_invariants=False)
            gk = g[:, k * f:(k + 1) * f].contiguous()
            fk = fs[:, k * f:(k + 1) * f].contiguous()
            total += cuda_ms(lambda: torch.sparse.mm(a, gk), iters=3)
            total += cuda_ms(lambda: torch.sparse.sampled_addmm(a, fk, gk.t(), beta=0.0), iters=3)
            del a, gk, fk
        return total
    except (RuntimeError, TypeError) as exc:
        print(f"library yardstick sparse.mm + sampled_addmm unavailable: {exc}")
        return None


@timed_phase
def phase_rowmask_ppi(dev, ppi):
    """The rowmask route at 32 x 4 on the PPI-sized graph (818,716 edges:
    the bf16 stream): ``sparse_gat_attention`` forward and backward with the
    launch counts set to 0 just before and read just after (K5, K1 with
    heads and the denominator, K2 with heads, the no-gather sum twice); the
    output, ``d feat``, ``d el`` and ``d er`` against an f64 recomputation
    (``ROWMASK_OUT_TOL``, ``ROWMASK_SCORE_TOL``); then each kernel at the
    route's own shapes, held against its plain version and timed beside it,
    a library yardstick and its bound by bytes, with the longest work item
    of its launch."""
    from stgraph_tpu_torch.ops import attention as A
    from stgraph_tpu_torch.ops import segment_kernels as SK
    from stgraph_tpu_torch.ops import spmm_cuda
    from stgraph_tpu_torch.ops.spmm_blocked import positions_in
    from stgraph_tpu_torch.ops.spmm_kernels import (
        K1_CHUNK,
        K2_CHUNK,
        spmm_rowmask,
        spmm_rowmask_bwd,
        spmm_rowmask_bwd_plain,
        spmm_rowmask_plain,
    )

    graph = ppi["graph"]
    csr, csr_t = graph.fwd_csr, graph.bwd_csr
    n = csr.num_nodes
    e = csr.num_edges
    h, f = ROWMASK_PPI_TILING
    stream = spmm_cuda._stream_dtype(csr, torch.float32)
    check(stream == torch.bfloat16, "the PPI-sized graph should stream bf16")
    gen = torch.Generator(device=dev).manual_seed(19)
    el, er = (torch.randn(n, h, device=dev, generator=gen) for _ in range(2))
    fs, g = (torch.randn(n, h, f, device=dev, generator=gen) for _ in range(2))
    ts = [t.clone().requires_grad_() for t in (el, er, fs)]
    reset_counts()
    t = time.perf_counter()
    out = A.sparse_gat_attention(csr, ts[0][..., None], ts[1][..., None], ts[2], negative_slope=GAT_SLOPE,
                                 csr_t=csr_t)
    (out * g).sum().backward()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    counts = read_counts()
    check(counts == only(K1=1, K2=1, K5=1, K1_nogather=2), f"the rowmask route at PPI size launched {counts}")
    refs, masses = rowmask_reference(csr, el, er, fs, g, GAT_SLOPE)
    errs = {}
    for name, got, ref, mass, tol in zip(
            ("out", "d el", "d er", "d feat"), (out.detach(), ts[0].grad, ts[1].grad, ts[2].grad), refs, masses,
            (ROWMASK_OUT_TOL, ROWMASK_SCORE_TOL, ROWMASK_SCORE_TOL, ROWMASK_OUT_TOL)):
        err = (got.double() - ref).abs()
        ratio = _err_over_mass(err, mass)
        errs[name] = {"max_abs_err": err.max().item(), "err_over_mass": ratio, "tol": tol}
        print(f"rowmask-ppi {name}: vs f64 max_abs_err {err.max().item():.3e}, worst err/sum|terms| "
              f"{ratio:.2e} (tol {tol:.4g}) {'ok' if ratio <= tol else 'FAIL'}")
        check(ratio <= tol, f"the rowmask route at PPI size: {name} disagrees with the f64 recomputation ({ratio})")
    del refs, masses, out
    print(f"rowmask-ppi: N={n} E={e} {h} x {f} bf16 stream, forward + backward {step_s:.4f} s (host clock, "
          f"first call), launches {counts}")

    # each kernel at the route's own shapes
    records, worst = {}, {"K5": 0.0, "K1_nogather": 0.0, "K1": 0.0, "K2": 0.0}
    block = COMPOSED_PLAIN_EDGE_BLOCK
    with torch.inference_mode():
        rows, cols = csr.rows_clamped, csr.cols_clamped
        s0 = el.index_select(0, cols) + er.index_select(0, rows)
        s = torch.where(s0 >= 0, s0, GAT_SLOPE * s0)
        m = SK.segment_max_wide(csr, s)
        check(torch.equal(m, SK.segment_max_wide_plain(csr, s, block)), "K5 at the PPI shape differs from plain")
        w = torch.where(csr.edge_mask[:, None], torch.exp(s - m.index_select(0, rows)), torch.zeros((), device=dev))
        fs2 = fs.reshape(n, h * f)
        gu = torch.randn(n, h * f, device=dev, generator=gen)
        w_t = w.index_select(0, positions_in(csr, csr_t.eids))
        ds0 = torch.randn(csr.capacity, h, device=dev, generator=gen) * w
        ds0_t = ds0.index_select(0, positions_in(csr, csr_t.eids))
        cases = (
            ("K5", "forward", csr, lambda: SK.segment_max_wide(csr, s),
             lambda: SK.segment_max_wide_plain(csr, s, block), None,
             lambda: _library_segment_sum_ms(csr, s, e, "max"), wide_bound(n, e, h), "torch.segment_reduce(max)"),
            ("K1_nogather", "transpose (d el)", csr_t, lambda: SK.segment_sum_wide(csr_t, ds0_t),
             lambda: SK.segment_sum_wide_plain(csr_t, ds0_t, block),
             lambda: SK.segment_sum_wide_plain(csr_t, ds0_t.abs(), block),
             lambda: _library_segment_sum_ms(csr_t, ds0_t, e), wide_bound(n, e, h), "torch.segment_reduce(sum)"),
            ("K1_nogather", "forward (d er)", csr, lambda: SK.segment_sum_wide(csr, ds0),
             lambda: SK.segment_sum_wide_plain(csr, ds0, block),
             lambda: SK.segment_sum_wide_plain(csr, ds0.abs(), block),
             lambda: _library_segment_sum_ms(csr, ds0, e), wide_bound(n, e, h), "torch.segment_reduce(sum)"),
            ("K1", "forward", csr,
             lambda: spmm_rowmask(csr, w, fs2, heads=h, with_denom=True, stream_dtype=stream),
             lambda: spmm_rowmask_plain(csr, w, fs2, stream, block, heads=h, with_denom=True),
             lambda: (spmm_rowmask_plain(csr, w, fs2.abs(), stream, block, heads=h),
                      spmm_rowmask_plain(csr, w, fs2, stream, block, heads=h, with_denom=True)[1]),
             lambda: _library_blockdiag_ms(csr, w, fs2, h, e, iters=10), rowmask_bound(n, e, h, f),
             "torch.sparse.mm, one call over the block-diagonal-by-head pattern"),
            ("K2", "transpose", csr_t,
             lambda: spmm_rowmask_bwd(csr_t, w_t, gu, fs2, stream_dtype=stream, heads=h),
             lambda: spmm_rowmask_bwd_plain(csr_t, w_t, gu, fs2, stream, block, heads=h),
             lambda: spmm_rowmask_bwd_plain(csr_t, w_t, gu.abs(), fs2.abs(), stream, block, heads=h),
             lambda: _library_multihead_bwd_ms(csr_t, w_t, gu, fs2, h, e), rowmask_bwd_bound(n, e, h, f),
             "torch.sparse.mm + torch.sparse.sampled_addmm, one each a head"),
        )
        for key, where, c, kernel, plain, mass, library, bound, lib_name in cases:
            if key in ("K1", "K1_nogather"):
                got = poisoned_call((c.num_nodes, h * f if key == "K1" else h), kernel)
            elif key == "K2":
                got = poisoned_k2_call((c.num_nodes, h * f), (c.capacity, h), kernel)
            else:  # K5
                got = poisoned_call((c.num_nodes, h), kernel)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            ref = plain()
            ref = ref if isinstance(ref, tuple) else (ref,)
            if mass is None:  # a maximum: bit for bit
                a, r = (0.0, 0.0) if torch.equal(got[0], ref[0]) else (float("inf"), float("inf"))
            else:
                ms_ = mass()
                ms_ = ms_ if isinstance(ms_, tuple) else (ms_,)
                stats = _stats([x for x in got if x is not None], list(ref), list(ms_))
                a, r = max(x[0] for x in stats), max(x[1] for x in stats)
            check(r <= KERNEL_TOL, f"{key} at the PPI shape ({where}) disagrees with its plain version: {r}")
            del got, ref
            ms = cuda_ms(kernel, iters=20, warmup=2)
            plain_ms = cuda_ms(plain, iters=2, warmup=1)
            lib = library()
            bound_ms, bound_by, nbytes, ops = bound
            item = longest_item(c, K1_CHUNK["heads"] if key == "K1" else K1_CHUNK["nogather"]
                                if key == "K1_nogather" else K2_CHUNK["heads"] if key == "K2" else SK.K5_CHUNK)
            if key in ("K1", "K2"):
                sname = "bf16"
            else:  # K5 reads f32; the no-gather sum by its rule (818,716 slots: bf16)
                sname = "bf16" if key == "K1_nogather" and SK.wide_stream_is_bf16(c, ds0) else "f32"
            print(f"{key}-ppi {where} {h} x {f} ({sname}): {ms:.4f} ms (plain {plain_ms:.2f} ms, {lib_name} "
                  f"{lib} ms, bound {bound_ms:.4f} ms by {bound_by}); longest item {item} edges; max_abs_err "
                  f"{a:.3e} (err/sum|terms| {r:.2e})")
            worst[key] = max(worst[key], a)
            records.setdefault(key, []).append(
                {"where": where, "H": h, "F": f if key in ("K1", "K2") else 1, "E": e, "N": n, "stream": sname,
                 "longest_item": item, "ms": ms, "plain_ms": plain_ms, "library_ms": lib, "library": lib_name,
                 "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes, "ops": ops, "max_abs_err": a,
                 "err_over_mass": r})
        records["K5"][0].update(device_launches(lambda: SK.segment_max_wide(csr, s), SK.segment_max_wide))
        # beside the single call, the H calls of one head each
        records["K1"][0]["library_heads_ms"] = _library_multihead_ms(csr, w, fs2, h, e)
        print(f"K1-ppi forward {h} x {f}: {h} x sparse.mm {records['K1'][0]['library_heads_ms']} ms")
    return {"counts": counts, "errors": errs, "step_s": step_s, "per_launch": records, "max_abs_err": worst}


# -- dynamic graphs: the lazy store pair, K6 and K7 --------------------------


def dyn_stream(rng, nodes, e0, steps, slide):
    """``bench_dyn``'s workload: ``e0`` initial edges as (row = dst, col =
    src) sorted by (row, col), and ``gen_delta_stream``'s additions,
    deletions and final live set from them."""
    keys = np.unique(rng.integers(0, nodes, e0 * 2).astype(np.int64) * nodes + rng.integers(0, nodes, e0 * 2))[:e0]
    rows0, cols0 = (keys // nodes).astype(np.int32), (keys % nodes).astype(np.int32)
    return (rows0, cols0) + gen_delta_stream(rng, cols0.astype(np.int64) * nodes + rows0, nodes, steps, slide)


def gen_delta_stream(rng, keys0, nodes, steps, slide):
    """``benchmarking/micro/_workload.py``'s delta stream (a copy): every
    delete names a live edge, every add is absent, the live set is kept on
    the host with a swap-remove pool. Returns (adds, dels) of shape
    (steps, slide, 2) int32 in (src, dst) order, and the final live set of
    keys ``src * nodes + dst``."""
    pool = np.empty((len(keys0) + steps * slide + 1,), np.int64)
    pool[: len(keys0)] = keys0
    count = len(keys0)
    live = set(keys0.tolist())
    adds = np.full((steps, slide, 2), nodes, np.int32)
    dels = np.full((steps, slide, 2), nodes, np.int32)
    for t in range(steps):
        taken = 0
        while taken < slide:  # deletes: swap-remove live keys (skip stale ones)
            j = int(rng.integers(0, count))
            k = int(pool[j])
            count -= 1
            pool[j] = pool[count]
            if k in live:
                live.discard(k)
                dels[t, taken] = (k // nodes, k % nodes)
                taken += 1
        taken = 0
        while taken < slide:  # adds: fresh keys not live now
            k = int(rng.integers(0, nodes)) * nodes + int(rng.integers(0, nodes))
            if k not in live:
                live.add(k)
                pool[count] = k
                count += 1
                adds[t, taken] = (k // nodes, k % nodes)
                taken += 1
    return adds, dels, live


def rowid_bounds(cap: int, n: int, f: int, live: int, weighted: bool = True):
    """Least times for one K6 call (rows, cols and, when ``weighted``, w
    read once, the f32 table read once, the f32 output written once; or a
    product and an add per live slot and column, an add alone unweighted)
    and one K7 call (rows read, and w when ``weighted``: its indicator and
    sum modes, not its count mode; den written; or one add per slot)."""
    w_bytes = 4 if weighted else 0
    k6_bytes, k6_ops = cap * (8 + w_bytes) + 2 * n * f * 4, (2 if weighted else 1) * live * f
    k7_bytes, k7_ops = cap * (4 + w_bytes) + n * 4, cap
    out = []
    for nbytes, ops in ((k6_bytes, k6_ops), (k7_bytes, k7_ops)):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
        out.append((max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", nbytes, ops))
    return out


def rowid_csr(rows, cols, w, n: int):
    """A flat store's slots that count as an (n, n) CSR, for the library
    yardstick ``torch.sparse.mm`` (timed only; the port never calls it):
    sentinels (row id n) dropped, and tombstones (w = 0) when weighted; the
    weights, or ones, as its values. A live-sorted store's row ids are
    already in order."""
    sel = rows < n if w is None else (rows < n) & (w > 0)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.cumsum(torch.bincount(rows[sel].long(), minlength=n), 0)
    vals = torch.ones(int(sel.sum()), device=rows.device) if w is None else w[sel]
    return torch.sparse_csr_tensor(crow, cols[sel].long(), vals, size=(n, n), check_invariants=False)


def device_launches(fn, counter, calls: int = 5) -> dict:
    """What one call of ``fn`` adds to the wrapper's count (``counter``, a
    kernel wrapper: one a call, whatever the call launches), and the device
    work the profiler sees over ``calls`` calls (kernels, fills, copies;
    ``profiled``) with its names and its device ms a call (each kernel's
    mean event, summed over the kernels): the launches a call, measured;
    None where the profiler saw no device work (not measured), and the
    launches it issued without a device event in the profile."""
    before = counter.launches
    fn()
    torch.cuda.synchronize()
    launches = counter.launches - before

    def repeat():
        for _ in range(calls):
            fn()

    events, issued, _, _ = profiled(repeat)
    by_name = {}
    for name, start, end in events:
        by_name.setdefault(name, []).append((end - start) / 1e6)
    seen = len(events)
    return {"wrapper_count_per_call": launches, "device_work_per_call": seen / calls if seen else None,
            # each kernel's mean event, summed
            "device_ms_per_call": sum(sum(t) / len(t) for t in by_name.values()) if seen else None,
            "kernels_of_a_call": sorted(by_name), "profile_launches": issued}


def k7_at_shape(rows, w, n, where):
    """K7 as ``lazy_norm`` calls it (the indicator of ``w > 0``) on a store of
    a main path: bit for bit against its plain version into a poisoned
    output, then timed beside the plain version, ``torch.bincount`` and its
    bound, with the device launches of one call."""
    from stgraph_tpu_torch.ops.rowid_kernels import dyn_degree, dyn_degree_plain

    cap = rows.numel()
    ind = torch.where(w > 0, 1.0, 0.0)
    ref = dyn_degree_plain(rows, ind, n)
    den = poisoned_call((n,), lambda: dyn_degree(rows, w, n, indicator=True))
    check(torch.equal(den, ref), f"K7 at {where} is not bit-equal to its plain version")
    bound_ms, bound_by, nbytes, ops = rowid_bounds(cap, n, 1, cap)[1]
    ms = cuda_ms(lambda: dyn_degree(rows, w, n, indicator=True), iters=200, warmup=5)
    plain_ms = cuda_ms(lambda: dyn_degree_plain(rows, ind, n), iters=3)
    try:  # a timed yardstick only; the port never calls it
        lib_equal = torch.equal(torch.bincount(rows, weights=ind, minlength=n + 1)[:n].float(), den)
        lib_ms = cuda_ms(lambda: torch.bincount(rows, weights=ind, minlength=n + 1), iters=50)
    except RuntimeError as exc:
        print(f"library yardstick bincount unavailable: {exc}")
        lib_ms, lib_equal = None, None
    launches = device_launches(lambda: dyn_degree(rows, w, n, indicator=True), dyn_degree)
    print(f"k7-main {where}: N={n}, {cap} slots: {ms * 1e3:.2f} us (plain {plain_ms * 1e3:.1f} us, torch.bincount "
          f"{lib_ms} ms, bound {bound_ms * 1e3:.2f} us by {bound_by}), wrapper count "
          f"{launches['wrapper_count_per_call']} a call (device work {launches['device_work_per_call']} "
          f"{launches['kernels_of_a_call']}); bit-equal, no NaN; bincount equal {lib_equal}")
    return {"where": where, "N": n, "slots": cap, "live": int(((rows < n) & (w > 0)).sum()), "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "library_equal": lib_equal, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "ops": ops, "max_abs_err": 0.0, **launches}


def k5_at_shape(csr, vals, where):
    """K5 on the rowmask route's (E, H) scores: bit for bit against its plain
    version into a poisoned output, then timed beside the plain version,
    ``torch.segment_reduce`` and its bound, with the device launches of one
    call."""
    from stgraph_tpu_torch.ops import segment_kernels as SK

    n, e, k = csr.num_nodes, csr.num_edges, vals.shape[1]
    SK.segment_max_wide(csr, vals)  # the work items, built once
    out = poisoned_call((n, k), lambda: SK.segment_max_wide(csr, vals))
    check(torch.equal(out, SK.segment_max_wide_plain(csr, vals, COMPOSED_PLAIN_EDGE_BLOCK)),
          f"K5 at {where} differs from its plain version")
    bound_ms, bound_by, nbytes, ops = wide_bound(n, e, k)
    ms = cuda_ms(lambda: SK.segment_max_wide(csr, vals), iters=100, warmup=3)
    plain_ms = cuda_ms(lambda: SK.segment_max_wide_plain(csr, vals, COMPOSED_PLAIN_EDGE_BLOCK), iters=2)
    lib_ms = _library_segment_sum_ms(csr, vals, e, "max")
    launches = device_launches(lambda: SK.segment_max_wide(csr, vals), SK.segment_max_wide)
    print(f"k5-main {where}: N={n} E={e} K={k}: {ms * 1e3:.2f} us (plain {plain_ms:.3f} ms, "
          f"torch.segment_reduce(max) {lib_ms} ms, bound {bound_ms * 1e3:.2f} us by {bound_by}), "
          f"wrapper count {launches['wrapper_count_per_call']} a call (device work {launches['device_work_per_call']} "
          f"{launches['kernels_of_a_call']}); bit-equal")
    return {"where": where, "H": k, "E": e, "N": n, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "torch.segment_reduce(max)", "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops, "max_abs_err": 0.0, **launches}


def adversarial_rowid_store(rng, n, chunk):
    """A live-sorted store in K6's chunks of ``chunk`` slots: random rows
    below 100 in chunk 0, an all-sentinel chunk 1, row 150 over chunks 2-4
    with sentinels inside its run, row 151 of tombstones alone across the
    boundary of chunk 5, rows 201-299 without slots across the boundary of
    chunks 5 and 6, the last live row 400, then sentinel chunks (rows 401 to
    n - 1 have no slot). Weights in [0.1, 1.1), 0 on sentinels and
    tombstones."""
    c = chunk
    rows = np.full(9 * c, n, np.int64)
    rows[: c - 20] = np.sort(rng.integers(0, 100, c - 20))
    rows[2 * c:5 * c] = 150
    rows[2 * c + rng.choice(3 * c, 40, replace=False)] = n
    rows[5 * c - 30:5 * c + 30] = 151
    rows[5 * c + 30:6 * c] = np.sort(rng.integers(152, 201, c - 30))
    rows[6 * c:7 * c - 50] = np.sort(rng.integers(300, 401, c - 50))
    rows[6 * c], rows[7 * c - 51] = 300, 400
    cols = np.where(rows < n, rng.integers(0, n, rows.size), n)
    w = (rng.random(rows.size) + 0.1).astype(np.float32)
    w[(rows >= n) | (rows == 151)] = 0.0
    return rows, cols, w


@timed_phase
def phase_rowid_kernels_vs_plain(dev, rng, n=200_000, slots=2_000_000, hub_slots=150_000):
    """K6 and K7 against their plain versions on a live-sorted flat store with
    sentinel slots spread through it (5 %), tombstones (10 %, w = 0), 1000
    empty rows and a hub row of ``hub_slots`` slots, and on
    ``adversarial_rowid_store``; weighted, unweighted (w in {0, 1}, the lazy
    store's) and w = None, at F in {8, 32, 128} (K6), and K7 also in its
    indicator mode. K6's chunk plan (launch 1) is held bit for bit against
    ``rowid_chunk_plan``, and each output takes a block poisoned with NaN
    (``poisoned_call``)."""
    from stgraph_tpu_torch.ops.rowid_kernels import (
        EDGE_CHUNK,
        dyn_degree,
        dyn_degree_plain,
        rowid_chunk_plan,
        spmm_rowid_plain,
        spmm_rowid_with_plan,
    )

    empty = 1000
    rows = rng.integers(0, n - empty, slots)
    rows[:hub_slots] = 12_345
    rows = np.sort(rows)
    cols = rng.integers(0, n, slots)
    sentinel = rng.random(slots) < 0.05
    rows[sentinel], cols[sentinel] = n, n
    w = (rng.random(slots) + 0.1).astype(np.float32)
    w[sentinel] = 0.0
    w[rng.random(slots) < 0.1] = 0.0
    stores = {"random": (rows, cols, w), "adversarial": adversarial_rowid_store(rng, n, EDGE_CHUNK)}
    results, worst = [], {"K6": 0.0, "K7": 0.0}
    for store, (r_np, c_np, w_np) in stores.items():
        rows_t, cols_t = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (r_np, c_np))
        w_t = torch.from_numpy(w_np).to(dev)
        modes = {"weighted": w_t, "unweighted": (w_t > 0).float(), "w=None": None}
        plan = rowid_chunk_plan(rows_t, n)
        for f in ROWID_CHECK_F:
            x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
            for mode, ww in modes.items():
                out, *got = poisoned_call((n, f), lambda: spmm_rowid_with_plan(rows_t, cols_t, ww, x, n))
                check(all(torch.equal(a, b) for a, b in zip(got, plan)),
                      f"K6's chunk plan differs from rowid_chunk_plan ({store} store)")
                ref = spmm_rowid_plain(rows_t, cols_t, ww, x, n, ROWID_PLAIN_EDGE_BLOCK)
                mass = spmm_rowid_plain(rows_t, cols_t, None if ww is None else ww.abs(), x.abs(), n,
                                        ROWID_PLAIN_EDGE_BLOCK)
                err = (out - ref).abs()
                ratio = _err_over_mass(err, mass)
                ok = ratio <= KERNEL_TOL and not out[n - empty:].any().item()
                print(f"k6-check {store} store F={f} {mode}: plan bit-equal, no NaN; max_abs_err "
                      f"{err.max().item():.3e} (max |plain| {ref.abs().max().item():.1f}), worst err/sum|terms| "
                      f"{ratio:.2e} (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
                check(ok, f"K6 disagrees with its plain version at F={f} {mode} ({store} store)")
                worst["K6"] = max(worst["K6"], err.max().item())
                results.append({"kernel": "K6", "store": store, "F": f, "mode": mode,
                                "max_abs_err": err.max().item(), "err_over_mass": ratio})
                del out, ref, mass, err
    for store, (r_np, _, w_np) in stores.items():
        rows_t, w_t = torch.from_numpy(r_np.astype(np.int32)).to(dev), torch.from_numpy(w_np).to(dev)
        modes = {"weighted": (w_t, False), "unweighted": ((w_t > 0).float(), False), "w=None": (None, False),
                 "indicator": (w_t, True)}
        for mode, (ww, ind) in modes.items():
            den = poisoned_call((n,), lambda: dyn_degree(rows_t, ww, n, indicator=ind))
            ref = dyn_degree_plain(rows_t, (w_t > 0).float() if ind else ww, n)
            err = (den - ref).abs()
            # counts are exact; a weight sum (w > 0) is its own sum of |terms|
            ok = (torch.equal(den, ref) if mode != "weighted" else _err_over_mass(err, ref) <= KERNEL_TOL)
            ok = ok and not den[n - empty:].any().item()
            print(f"k7-check {store} store {mode}: no NaN; max_abs_err {err.max().item():.3e} (max |plain| "
                  f"{ref.max().item():.1f}), "
                  f"{'bit-equal' if torch.equal(den, ref) else 'err/sum|terms| %.2e' % _err_over_mass(err, ref)} "
                  f"{'ok' if ok else 'FAIL'}")
            check(ok, f"K7 disagrees with its plain version ({mode}, {store} store)")
            worst["K7"] = max(worst["K7"], err.max().item())
            results.append({"kernel": "K7", "store": store, "mode": mode, "max_abs_err": err.max().item()})
    return {"store": {"n": n, "slots": slots, "empty_rows": empty, "hub_slots": hub_slots,
                      "sentinel_share": 0.05, "tombstone_share": 0.1},
            "cases": results, "max_abs_err": worst}


def live_keys(store, key):
    """The live edge set of a lazy store as sorted keys: live main slots and
    live tail entries, less one per anti entry. Fails unless every anti entry
    cancels a positive entry and no key is live twice."""
    n = store.num_nodes
    r, c, w = (t.cpu().numpy() for t in (store.rows, store.cols, store.w))
    tr, tc, tw = (t.cpu().numpy() for t in (store.tail_rows, store.tail_cols, store.tail_w))
    ar, ac = store.anti_rows.cpu().numpy(), store.anti_cols.cpu().numpy()
    main, tail, anti = (r < n) & (w > 0), (tr < n) & (tw > 0), ar < n
    pos = np.concatenate([key(r[main], c[main]), key(tr[tail], tc[tail])])
    keys, counts = np.unique(pos, return_counts=True)
    neg, neg_counts = np.unique(key(ar[anti], ac[anti]), return_counts=True)
    idx = np.searchsorted(keys, neg)
    check(bool(np.all(idx < len(keys))) and bool(np.all(keys[np.minimum(idx, len(keys) - 1)] == neg)),
          "an anti-log entry cancels no live edge")
    counts[idx] -= neg_counts
    check(bool(np.all((counts == 0) | (counts == 1))), "a key is live twice in the lazy store")
    return keys[counts == 1]


@timed_phase
def phase_dyn_step(dev, seed):
    """``bench.py``'s ``bench_dyn`` on the port: the lazy store pair at the
    wiki-talk scale (1.1M nodes, capacity 2.2M, tail 160k, ~2.0M initial
    edges), 64 steps of 10k adds and 10k deletes; per step the update and
    ``lazy_spmm`` at F = 128, then the update alone, the aggregation alone
    and K1 on a static CSR of the initial edges. One K6 a step."""
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops.dyn_spmm import apply_delta_lazy_pair, lazy_pair_from_edges, lazy_spmm
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask

    rng = np.random.default_rng(seed)
    nodes, cap, slide, steps, f, tcap = DYN_NODES, DYN_CAP, DYN_SLIDE, DYN_STEPS, DYN_F, DYN_TCAP
    t0 = time.perf_counter()
    e0 = cap - tcap - 40_000
    rows0, cols0, adds, dels, live = dyn_stream(rng, nodes, e0, steps, slide)
    t1 = time.perf_counter()
    pair0 = lazy_pair_from_edges(cols0, rows0, nodes, capacity=cap, tail_capacity=tcap, device=dev)
    feats = torch.from_numpy(rng.standard_normal((nodes, f)).astype(np.float32)).to(dev)
    adds_t, dels_t = torch.from_numpy(adds).to(dev), torch.from_numpy(dels).to(dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"dyn-step setup: {e0} initial edges on {nodes} nodes, capacity {cap}, tail {tcap}, {steps} steps of "
          f"{slide} adds + {slide} deletes: stream {t1 - t0:.2f} s, pair build + upload {t2 - t1:.2f} s")

    def update(pair, s):
        return apply_delta_lazy_pair(pair, adds_t[s, :, 0], adds_t[s, :, 1], dels_t[s, :, 0], dels_t[s, :, 1])

    def run(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) / steps

    # Each loop reduces every output to a sum and keeps nothing, as
    # bench_dyn's scans do: holding 64 outputs of 563 MB would time the
    # allocator.
    def step_loop():
        pair, compactions = pair0, 0
        for s in range(steps):
            nxt = update(pair, s)
            compactions += nxt.fwd.tail_count < pair.fwd.tail_count
            pair = nxt
            lazy_spmm(pair, feats).sum()
        return pair, compactions

    def update_loop():
        pair = pair0
        for s in range(steps):
            pair = update(pair, s)
        return pair

    def repeat(fn):
        for _ in range(steps):
            fn().sum()

    csr = build_csr(cols0, rows0, nodes, device=dev)
    with torch.no_grad():
        run(step_loop)  # warm
        reset_counts()
        (pair, compactions), step_s = run(step_loop)
        counts = read_counts()
        _, update_s = run(update_loop)
        _, agg_s = run(lambda: repeat(lambda: lazy_spmm(pair0, feats)))
        spmm_rowmask(csr, None, feats)  # warm
        _, static_s = run(lambda: repeat(lambda: spmm_rowmask(csr, None, feats)[0]))
    print(f"dyn-step: update + lazy_spmm {step_s * 1e3:.3f} ms a step, update only {update_s * 1e3:.3f} ms, "
          f"aggregation only {agg_s * 1e3:.3f} ms, static K1 (f32 stream) {static_s * 1e3:.3f} ms; "
          f"{compactions} compactions per store; launches {counts}")
    check(counts == only(K6=steps), f"the dyn-step run launched {counts}, expected one K6 a step")
    want = np.array(sorted(live), np.int64)
    fwd = live_keys(pair.fwd, lambda r, c: c.astype(np.int64) * nodes + r)
    bwd = live_keys(pair.bwd, lambda r, c: r.astype(np.int64) * nodes + c)
    ok = (np.array_equal(fwd, want) and np.array_equal(bwd, want)
          and int(pair.fwd.num_edges) == int(pair.bwd.num_edges) == len(want))
    print(f"dyn-step live set after {steps} steps: fwd {len(fwd)}, bwd {len(bwd)}, generator {len(want)} "
          f"edges, equal {ok}")
    check(ok, "the lazy pair's live set differs from the generator's after the dyn-step run")
    return {"pair": pair, "feats": feats, "stream": (rows0, cols0, adds, dels, want),
            "record": {"nodes": nodes, "capacity": cap, "tail_capacity": tcap, "initial_edges": int(e0),
                       "steps": steps, "slide": slide, "F": f, "compactions_per_store": int(compactions),
                       "stream_s": t1 - t0, "build_s": t2 - t1, "step_s": step_s, "update_s": update_s,
                       "agg_s": agg_s, "static_k1_s": static_s, "launches": counts,
                       "live_edges": len(want)}}


@timed_phase
def phase_rowid_at_main_shapes(dyn):
    """K6 and K7 on the dyn-step store after its 64 steps (tombstones and
    logs in use), F = 128: each kernel, its plain version and a library call
    timed, full outputs compared into poisoned blocks (K6's chunk plan bit
    for bit against ``rowid_chunk_plan``; K7 as ``lazy_norm`` calls it,
    ``k7_at_shape``)."""
    from stgraph_tpu_torch.ops.rowid_kernels import (
        rowid_chunk_plan,
        spmm_rowid,
        spmm_rowid_plain,
        spmm_rowid_with_plan,
    )

    st, feats = dyn["pair"].fwd, dyn["feats"]
    n, f = feats.shape
    rows, cols, w = st.rows, st.cols, st.w
    cap = rows.numel()
    live = int(((rows < n) & (w > 0)).sum())
    b6, by6, bytes6, ops6 = rowid_bounds(cap, n, f, live)[0]
    out = {}
    with torch.no_grad():
        res, *got = poisoned_call((n, f), lambda: spmm_rowid_with_plan(rows, cols, w, feats, n))
        check(all(torch.equal(a, b) for a, b in zip(got, rowid_chunk_plan(rows, n))),
              "K6's chunk plan at the dyn-step shape differs from rowid_chunk_plan")
        del got
        ref = spmm_rowid_plain(rows, cols, w, feats, n, ROWID_PLAIN_EDGE_BLOCK)
        err = (res - ref).abs()
        k6_err = err.max().item()
        ratio = _err_over_mass(err, spmm_rowid_plain(rows, cols, w.abs(), feats.abs(), n, ROWID_PLAIN_EDGE_BLOCK))
        check(ratio <= KERNEL_TOL, f"K6 at the dyn-step shape disagrees: err/sum|terms| {ratio}")
        ms = cuda_ms(lambda: spmm_rowid(rows, cols, w, feats, n), iters=10, warmup=2)
        plain_ms = cuda_ms(lambda: spmm_rowid_plain(rows, cols, w, feats, n, ROWID_PLAIN_EDGE_BLOCK), iters=1)
        t = time.perf_counter()
        lib_a = rowid_csr(rows, cols, w, n)
        torch.cuda.synchronize()
        lib_build_s = time.perf_counter() - t
        try:  # a timed yardstick only; the port never calls it
            lib_err = (torch.sparse.mm(lib_a, feats) - ref).abs().max().item()
            lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, feats), iters=5)
        except RuntimeError as exc:
            print(f"library yardstick sparse.mm unavailable: {exc}")
            lib_err, lib_ms = None, None
        del res, ref, err, lib_a
        print(f"k6-main F={f}: {ms:.3f} ms (plain {plain_ms:.1f} ms, torch.sparse.mm {lib_ms} ms + CSR build "
              f"{lib_build_s * 1e3:.1f} ms, bound {b6:.3f} ms by {by6}); {live} live of {cap} slots; max_abs_err "
              f"{k6_err:.3e}, worst err/sum|terms| {ratio:.2e}; sparse.mm vs plain max_abs_err {lib_err}")
        out["K6"] = [{"F": f, "N": n, "slots": cap, "live": live, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_build_s": lib_build_s, "library_max_abs_err": lib_err,
                      "bound_ms": b6, "bound_by": by6, "bytes": bytes6, "ops": ops6,
                      "max_abs_err": k6_err, "err_over_mass": ratio}]
        out["K7"] = [k7_at_shape(rows, w, n, "dyn-step")]  # lazy_norm's call
    return out, {"K6": out["K6"][0]["max_abs_err"], "K7": 0.0}


def wiki_shape_edges(num_nodes, edge_multiplier, add_coeff, delete_coeff, timestamps, seed=0):
    """``benchmarking/dataset/dataset_builder.py``'s ``build(..., sparse=True)``
    (a copy, edge lists only): a random sparse graph of ``N * M`` edges, then
    per timestamp ``D`` of the edges deleted and ``A * E`` new ones added."""
    rng = np.random.default_rng(seed)
    target = max(int(num_nodes * edge_multiplier), 1)

    def sample(k):
        e = rng.integers(0, num_nodes, (int(k * 1.2) + 8, 2), dtype=np.int64)
        e = e[e[:, 0] != e[:, 1]]
        _, idx = np.unique(e[:, 0] * num_nodes + e[:, 1], return_index=True)
        return e[np.sort(idx)][:k]

    current, lists = sample(target), []
    for t in range(timestamps):
        if t > 0:
            keep = rng.permutation(len(current))[int(len(current) * delete_coeff):]
            current = np.concatenate([current[keep], sample(int(target * add_coeff))])
            _, idx = np.unique(current[:, 0] * num_nodes + current[:, 1], return_index=True)
            current = current[np.sort(idx)]
        lists.append(current)
    return lists


def dtdg_dataset(name, workdir, lags=DTDG_LAGS):
    """(edge lists, weight lists or None, per-step (N, lags) features) of the
    dynamic drivers' two datasets here: England-COVID (weighted) and the
    wiki-talk-shaped stream with ``_SyntheticDTDG``'s out-degree features
    (unweighted, so the lazy store takes the anti-log path)."""
    from stgraph_tpu_torch.dataset import EnglandCovidDataLoader, STGraphDataset

    if name == "england-covid":
        STGraphDataset._offline = True  # no network here: the synthetic England-COVID
        d = EnglandCovidDataLoader(lags=lags, cache_dir=os.path.join(workdir, "datasets"))
        return d.get_edges(), d.get_edge_weights(), d.get_all_features()
    lists = wiki_shape_edges(**WIKI_SHAPE)
    n = 1 + max(int(e.max()) for e in lists)
    deg = np.zeros((len(lists), n), np.float32)
    for t, e in enumerate(lists):
        np.add.at(deg[t], e[:, 0], 1.0)
    deg /= max(deg.max(), 1.0)
    return lists, None, [deg[t:t + lags].T for t in range(len(lists) - lags)]


def dtdg_trainer(dev, name, workdir, graph_type="lazy-scan", lags=DTDG_LAGS, hidden=DTDG_HIDDEN, seed=0):
    """``drivers.dynamic_temporal_tgcn``'s trainer of ``graph_type`` on
    ``dtdg_dataset(name)``: TGCN(lags -> hidden), Adam(``DTDG_LR``), the
    parameters from ``seed``, the negatives from a generator seeded with
    ``seed + 7``. Returns (edge lists, weight lists, trainer)."""
    from stgraph_tpu_torch.drivers.dynamic_temporal_tgcn import DynamicTemporalTrainer

    edge_lists, weight_lists, feats = dtdg_dataset(name, workdir, lags)
    return edge_lists, weight_lists, DynamicTemporalTrainer(edge_lists, weight_lists, feats, graph_type, lags, hidden,
                                                            DTDG_LR, dev, seed)


@timed_phase
def phase_dtdg_training(dev, args, workdir, name):
    """``benchmarking/dynamic-temporal-tgcn/train.py --type lazy-scan`` on the
    port (``drivers.dynamic_temporal_tgcn``): the pair seeded from
    ``DeltaGraph.snapshot_store(lags - 1)``, the staged deltas trimmed to the
    window's largest batch, tail logs 8 batches wide; TGCN(8 -> 32), the
    link loss, Adam(1e-2), the whole epoch's backward through every
    timestep. 1 warm and 4 timed epochs, each launching 6T K6 and 3T K7;
    then K6 on pair.fwd and pair.bwd and K7 at the path's shapes against
    their plain versions, and the hidden states, loss and parameter
    gradients of one epoch against the same TGCN over ``NaiveGraph``
    snapshot CSRs (K1)."""
    from stgraph_tpu_torch.drivers.dynamic_temporal_tgcn import link_loss
    from stgraph_tpu_torch.graph import NaiveGraph
    from stgraph_tpu_torch.ops import spmm_cuda
    from stgraph_tpu_torch.ops.rowid_kernels import spmm_rowid, spmm_rowid_plain

    lags, hidden = DTDG_LAGS, DTDG_HIDDEN
    t0 = time.perf_counter()
    edge_lists, weight_lists, tr = dtdg_trainer(dev, name, workdir, seed=args.seed)
    n, steps, width, tcap, pair0, model = tr.num_nodes, tr.steps, tr.width, tr.tail_capacity, tr.pair0, tr.model
    capacity = pair0.fwd.capacity
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def step():
        loss = tr.epoch()
        torch.cuda.synchronize()
        return loss.item()

    t = time.perf_counter()
    warm_loss = step()
    warm_s = time.perf_counter() - t
    reset_counts()
    losses, times, per_epoch = [], [], []
    for _ in range(DTDG_EPOCHS):
        before = read_counts()
        t = time.perf_counter()
        losses.append(step())
        times.append(time.perf_counter() - t)
        per_epoch.append({k: v - before[k] for k, v in read_counts().items()})
    counts = read_counts()

    def updates_only():
        tr.updates_only()
        torch.cuda.synchronize()

    updates_only()
    t = time.perf_counter()
    updates_only()
    update_s = time.perf_counter() - t
    print(f"dtdg-training {name}: N={n}, T={steps}, up to {max(len(e) for e in edge_lists)} edges a snapshot, "
          f"batches of {width}, capacity {capacity}, tail {tcap}, weighted {weight_lists is not None} "
          f"(set-up {setup_s:.2f} s); warm epoch {warm_s:.3f} s (loss {warm_loss:.4f}); {DTDG_EPOCHS} Adam epochs, "
          f"s per epoch {[round(v, 4) for v in times]}, losses {[round(v, 4) for v in losses]}, updates alone "
          f"{update_s:.4f} s an epoch; launches {counts}")
    check(all(c == only(K6=6 * steps, K7=3 * steps) for c in per_epoch),
          f"a {name} epoch launched {per_epoch}, expected 6T K6 and 3T K7 (T = {steps})")
    check(all(np.isfinite(losses)) and np.isfinite(warm_loss), f"non-finite {name} loss")
    check(losses[-1] < warm_loss, f"the {name} loss did not fall: {warm_loss} then {losses}")
    profile = phase_profile(step, f"one {name} epoch")

    # K6 on pair.fwd and pair.bwd, and K7 with lazy_norm's weights, at this
    # path's shapes (the stores after the last timestep, (N, hidden) f32
    # operands), against their plain versions.
    pair = pair0
    for t in range(steps):
        pair = tr.update(pair, t)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 9)
    kernel_worst = {"K6": 0.0, "K7": 0.0}
    with torch.no_grad():
        for side, st in (("fwd", pair.fwd), ("bwd", pair.bwd)):
            x = torch.randn(n, hidden, device=dev, generator=gen)
            out = spmm_rowid(st.rows, st.cols, st.w, x, n)
            ref = spmm_rowid_plain(st.rows, st.cols, st.w, x, n)
            err = (out - ref).abs()
            ratio = _err_over_mass(err, spmm_rowid_plain(st.rows, st.cols, st.w.abs(), x.abs(), n))
            print(f"dtdg-k6 {name} pair.{side} (N={n}, {st.rows.numel()} slots, F={hidden}): max_abs_err "
                  f"{err.max().item():.3e}, worst err/sum|terms| {ratio:.2e} (tol {KERNEL_TOL:g}) "
                  f"{'ok' if ratio <= KERNEL_TOL else 'FAIL'}")
            check(ratio <= KERNEL_TOL, f"{name}: K6 on pair.{side} disagrees with its plain version")
            kernel_worst["K6"] = max(kernel_worst["K6"], err.max().item())
        k7 = k7_at_shape(pair.fwd.rows, pair.fwd.w, n, name)  # lazy_norm's call

    # The same TGCN over NaiveGraph snapshot CSRs (impl="kernel": K1 and its
    # backward, an f32 stream like the pair's), the same negatives and the
    # pair's positive slots: the hidden state at every timestep, the loss
    # and every parameter gradient of one epoch against the lazy pair's.
    naive = NaiveGraph(edge_lists, weight_lists, device=dev)
    for conv in (model.conv_z, model.conv_r, model.conv_h):
        conv.impl = "kernel"

    def epoch_grads(route):
        model.zero_grad(set_to_none=True)
        neg_gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
        h, losses, hs = torch.zeros(n, hidden, device=dev), [], []
        for t, (pair_t, _, rows, cols, mask) in enumerate(tr.timesteps()):
            if route == "pair":
                h = model(pair_t, tr.xs[t], hidden=h)
            else:
                h = model(naive.get_graph(t + lags), tr.xs[t], edge_weight=naive.get_edge_weights(t + lags), hidden=h)
            hs.append(h.detach())
            neg = [torch.randint(0, n, rows.shape, device=dev, generator=neg_gen) for _ in range(2)]
            losses.append(link_loss(h, rows, cols, mask, *neg))
        loss = torch.stack(losses).mean()
        forward = read_counts()
        loss.backward()
        return loss.item(), hs, {k: p.grad.clone() for k, p in model.named_parameters()}, forward

    limit = spmm_cuda._BF16_STREAM_MIN_EDGES
    spmm_cuda._BF16_STREAM_MIN_EDGES = 1 << 62
    try:
        reset_counts()
        loss_pair, hs_pair, grads_pair, _ = epoch_grads("pair")
        reset_counts()
        loss_naive, hs_naive, grads_naive, naive_fwd = epoch_grads("naive")
    finally:
        spmm_cuda._BF16_STREAM_MIN_EDGES = limit
    worst = max((a - b).abs().max().item() / max(b.abs().max().item(), 1e-30) for a, b in zip(hs_pair, hs_naive))
    grad_rows = {k: (grads_pair[k] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
                 for k, ref in grads_naive.items()}
    grad_worst = max(grad_rows.values())
    loss_err = abs(loss_pair - loss_naive) / abs(loss_naive)
    print(f"dtdg-check {name}: over {steps} timesteps, lazy pair (K6, K7) vs NaiveGraph snapshots "
          f"(K1 x {naive_fwd['K1']} forward): hidden worst max_abs_err / max |naive| {worst:.2e} (tol "
          f"{HIDDEN_TOL:g}); loss {loss_pair:.6f} vs {loss_naive:.6f}; parameter gradients worst max_abs_err / "
          f"max |naive| {grad_worst:.2e} (tol {DTDG_GRAD_TOL:g}) "
          f"{'ok' if worst <= HIDDEN_TOL and grad_worst <= DTDG_GRAD_TOL else 'FAIL'}")
    check(naive_fwd["K1"] == 3 * steps and worst <= HIDDEN_TOL, f"{name}: the lazy pair's hidden states disagree")
    check(loss_err <= HIDDEN_TOL and grad_worst <= DTDG_GRAD_TOL,
          f"{name}: the lazy pair's loss or gradients disagree with the snapshot path's: {grad_rows}")
    return {"n": n, "timesteps": steps, "batch_width": width, "capacity": capacity,
            "tail_capacity": tcap, "weighted": weight_lists is not None, "setup_s": setup_s,
            "warm_s": warm_s, "warm_loss": warm_loss, "epoch_s": times, "losses": losses,
            "update_s": update_s, "launches": counts, "launches_per_epoch": per_epoch,
            "kernel_max_abs_err": kernel_worst, "k7": k7, "hidden_worst_err_over_max": worst,
            "loss_vs_naive": [loss_pair, loss_naive], "grad_err_over_max": grad_rows, "profile": profile}


def dense_route(n):
    """Whether ``impl="auto"`` sends an N-node graph's f32 sums to the dense
    route (``ops.message._resolve_impl``'s rule)."""
    from stgraph_tpu_torch.ops import message as M

    return n * n * 4 <= M._DENSE_BUDGET_BYTES


def first_timesteps(tr, steps=TEMPORAL_PROFILE_STEPS, step=True):
    """The first ``steps`` timesteps of ``tr``'s epoch (a
    ``StaticTemporalTrainer``) as one window from a zero hidden state: the
    mean of their losses, its backward and, with ``step``, an Adam step."""
    tr.opt.zero_grad(set_to_none=True)
    h, losses = tr.zero_hidden(), []
    for t in range(min(steps, tr.total)):
        h, loss = tr._timestep(h, tr.feats[t], tr.ys[t])
        losses.append(loss)
    torch.stack(losses).mean().backward()
    if step:
        tr.opt.step()


def window_records(tr, windows=None, step=True):
    """Windows ``0 .. windows - 1`` (default all) of ``tr``'s epoch from a
    zero hidden state: each window's loss and gradients (cloned before its
    Adam step; no step with ``step=False``)."""
    h, out = tr.zero_hidden(), []
    for wi in range(tr.num_windows if windows is None else windows):
        loss, h = tr.window_backward(h, wi)
        grads = {k: p.grad.clone() for k, p in (*tr.model.named_parameters(), *(
            (f"head.{k}", p) for k, p in tr.head.named_parameters()))}
        out.append((loss.item(), grads))
        if step:
            tr.opt.step()
    torch.cuda.synchronize()
    return out


def compare_windows(got, ref):
    """(worst loss error over |loss|, worst gradient error over the tensor's
    largest element, by tensor) of two ``window_records``."""
    loss_err = max(abs(a[0] - b[0]) / max(abs(b[0]), 1e-30) for a, b in zip(got, ref))
    grad_err = {}
    for (_, ga), (_, gb) in zip(got, ref):
        for k, v in gb.items():
            grad_err[k] = max(grad_err.get(k, 0.0), (ga[k] - v).abs().max().item() / max(v.abs().max().item(), 1e-30))
    return loss_err, grad_err


@timed_phase
def phase_tgcn_epoch(dev, args, workdir):
    """``bench.py``'s ``bench_tgcn_epoch`` on the port
    (``drivers.static_temporal_tgcn.bench_tgcn_epoch``): TGCN(8, 16) and a
    one-unit head on WindmillOutput small at cutoff 100 (92 timesteps), the
    MSE over every timestep, one backward an epoch, no optimiser step; 2
    warm and 10 timed epochs. Eleven nodes take the dense route: no kernel
    launches, which the counts check. A profile of the first
    ``TEMPORAL_PROFILE_STEPS`` timesteps of the same trainer."""
    from stgraph_tpu_torch.dataset import STGraphDataset
    from stgraph_tpu_torch.drivers.static_temporal_tgcn import bench_tgcn_epoch, tgcn_epoch_trainer

    STGraphDataset._offline = True
    tr = tgcn_epoch_trainer(TGCN_EPOCH_CUTOFF, dev, os.path.join(workdir, "datasets"), args.seed)
    reset_counts()
    r = bench_tgcn_epoch(iters=TGCN_EPOCH_ITERS, warmup=TGCN_EPOCH_WARMUP, trainer=tr)
    counts = read_counts()
    check(counts == only(), f"tgcn-epoch launched {counts}: its 11-node graph must take the dense route")
    check(np.isfinite(r["loss"]), "non-finite tgcn-epoch loss")
    profile = phase_profile(lambda: first_timesteps(tr, step=False),
                            f"the first {TEMPORAL_PROFILE_STEPS} timesteps of a tgcn-epoch epoch")
    print(f"tgcn-epoch: WindmillOutput small, cutoff {TGCN_EPOCH_CUTOFF} ({r['timesteps']} timesteps), TGCN(8, 16) + "
          f"Dense(1), dense route (no kernel: launches {counts}): {r['tgcn_epoch_s']:.5f} s an epoch over "
          f"{TGCN_EPOCH_ITERS} after {TGCN_EPOCH_WARMUP} warm, loss {r['loss']:.5f}, idle share "
          f"{profile['idle_share']:.3f}")
    return {**r, "launches": counts, "profile": profile, "route": "dense (no kernel)"}


@timed_phase
def phase_static_temporal(dev, args, workdir, name, cutoff, bptt, impl, epochs):
    """``benchmarking/static-temporal-tgcn/train.py --dataset NAME --feat_size
    80 --num_hidden 160`` on the port (``drivers.static_temporal_tgcn``): a
    warm epoch (its windows' losses and gradients kept for the route checks)
    and ``epochs`` timed ones, each launching 3T K1 and 3T K2 on the kernel
    route and nothing on the dense one; the MSE finite and falling; a
    profile of the first ``TEMPORAL_PROFILE_STEPS`` timesteps of the same
    trainer (``first_timesteps``, after the timed epochs); on the dense
    route the time of the path's ``csr_to_dense`` calls (3 a timestep) beside
    the epoch's."""
    from stgraph_tpu_torch.dataset import STGraphDataset
    from stgraph_tpu_torch.drivers.static_temporal_tgcn import StaticTemporalTrainer, load_dataset
    from stgraph_tpu_torch.ops import message as M

    STGraphDataset._offline = True  # no network here: the synthetic data
    t0 = time.perf_counter()
    d = load_dataset(name, STATIC_F, cutoff, os.path.join(workdir, "datasets"))
    load_s = time.perf_counter() - t0
    tr = StaticTemporalTrainer(d, STATIC_F, STATIC_H, bptt, STATIC_LR, impl, device=dev, seed=args.seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n, e, steps = tr.num_nodes, len(d.get_edges()), tr.total

    def epoch():
        mse = tr.epoch()
        torch.cuda.synchronize()
        return mse

    kernel = impl == "kernel" or not dense_route(tr.num_nodes)
    expected = only(K1=3 * steps, K2=3 * steps) if kernel else only()
    reset_counts()
    t = time.perf_counter()
    warm_records = window_records(tr)
    warm_s = time.perf_counter() - t
    warm = sum(loss * len(tr.window_range(wi)) for wi, (loss, _) in enumerate(warm_records)) / steps
    check(read_counts() == expected, f"the warm {name} epoch launched {read_counts()}, expected {expected}")
    mses, times, per_epoch = [], [], []
    for _ in range(epochs):
        before = read_counts()
        t = time.perf_counter()
        mses.append(epoch())
        times.append(time.perf_counter() - t)
        per_epoch.append({k: v - before[k] for k, v in read_counts().items()})
    counts = read_counts()
    check(all(c == expected for c in per_epoch), f"a {name} epoch launched {per_epoch}, expected {expected}")
    check(all(np.isfinite(mses)) and np.isfinite(warm), f"non-finite {name} MSE")
    check(mses[-1] < warm, f"the {name} MSE did not fall: {warm} then {mses}")

    profile = phase_profile(lambda: first_timesteps(tr), f"the first {TEMPORAL_PROFILE_STEPS} timesteps of a "
                            f"{name} epoch")
    dense = None
    if not kernel:  # the dense route rebuilds the (N, N) adjacency at every GCNConv call
        csr = tr.graph.fwd_csr
        w = M.edge_data_to_csr_order(csr, tr.ew[:, None])
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3 * steps):
            M.csr_to_dense(csr, w)
        torch.cuda.synchronize()
        calls_s = time.perf_counter() - t
        dense = {"calls": 3 * steps, "s": calls_s, "share_of_epoch": calls_s / float(np.mean(times)),
                 "device_ms_a_call": cuda_ms(lambda: M.csr_to_dense(csr, w), iters=50, warmup=5)}
    print(f"static-temporal {name}: N={n}, E={e}, T={steps} timesteps in {tr.num_windows} window(s) of {tr.window}, "
          f"F={STATIC_F} H={STATIC_H}, {'kernel' if kernel else 'dense'} route (data {load_s:.2f} s, set-up "
          f"{setup_s:.2f} s); warm epoch {warm_s:.2f} s (MSE {warm:.5f}); {epochs} timed epoch(s), s "
          f"{[round(v, 3) for v in times]}, MSE {[round(v, 5) for v in mses]}; launches an epoch {per_epoch[0]}; "
          f"idle share {profile['idle_share']:.3f}"
          + ("" if dense is None else f"; csr_to_dense x{dense['calls']} {dense['s']:.3f} s alone "
             f"({dense['share_of_epoch']:.3f} of an epoch, {dense['device_ms_a_call']:.4f} ms of device a call)"))
    return {"trainer": tr, "data": d, "warm_records": warm_records, "record": {
        "dataset": name, "n": n, "e": e, "timesteps": steps, "window": tr.window, "windows": tr.num_windows,
        "route": "kernel" if kernel else "dense", "load_s": load_s, "setup_s": setup_s, "warm_s": warm_s,
        "warm_mse": warm, "epoch_s": times, "mse": mses, "launches": counts, "launches_per_epoch": per_epoch,
        "profile": profile, "profile_timesteps": TEMPORAL_PROFILE_STEPS, "csr_to_dense": dense}}


def k1_k2_at_temporal_shape(where, one_timestep, stream):
    """K1 and K2 with the arguments a temporal kernel route gives them at
    one timestep (``one_timestep()``, a forward and backward, during which
    ``ops.spmm_cuda``'s first K1 and K2 calls are recorded: the gate's
    (N, H) features, the lowering's CSR-order weights, the cotangent and
    the stream the route chose, which must be ``stream``), each against
    its plain version on that stream into poisoned outputs, then timed
    with its plain version, the library calls and its bound."""
    from stgraph_tpu_torch.ops import spmm_cuda
    from stgraph_tpu_torch.ops import spmm_kernels as SK

    calls = {}

    def recorder(key, fn):
        def record(*a, **k):
            calls.setdefault(key, (a, k))
            return fn(*a, **k)
        return record

    saved = spmm_cuda.spmm_rowmask, spmm_cuda.spmm_rowmask_bwd
    spmm_cuda.spmm_rowmask = recorder("K1", saved[0])
    spmm_cuda.spmm_rowmask_bwd = recorder("K2", saved[1])
    try:
        one_timestep()
        torch.cuda.synchronize()
    finally:
        spmm_cuda.spmm_rowmask, spmm_cuda.spmm_rowmask_bwd = saved
    (csr, w, x), k1_kw = calls["K1"]
    (csr_t, w_t, g, fs), k2_kw = calls["K2"]
    n, f = x.shape
    e = int(csr.host_arrays()[0][-1])
    name = {None: "f32", torch.bfloat16: "bf16"}[stream]
    got = k1_kw.get("stream_dtype"), k2_kw.get("stream_dtype")
    check(got == (stream, stream), f"the {where} route streamed {got}, expected {name}")
    out, _ = poisoned_call((n, f), lambda: SK.spmm_rowmask(csr, w, x, stream_dtype=stream))
    torch.cuda.synchronize()
    k1_err, k1_ratio, _ = k1_agreement(out, csr, w, x, stream)
    dh, dw = poisoned_k2_call((n, f), (csr_t.capacity, 1),
                              lambda: SK.spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=stream))
    torch.cuda.synchronize()
    (dh_err, dh_ratio, _), (dw_err, dw_ratio, _), pad_zero = k2_agreement(dh, dw, csr_t, w_t, g, fs, stream)
    ok = k1_ratio <= KERNEL_TOL and dh_ratio <= KERNEL_TOL and dw_ratio <= KERNEL_TOL and pad_zero
    print(f"temporal-k1-k2 {where} (N={n}, E={e}, F={f}, {name} stream): K1 max_abs_err {k1_err:.3e} "
          f"(err/sum|terms| {k1_ratio:.2e}); K2 dh {dh_err:.3e} ({dh_ratio:.2e}), dw {dw_err:.3e} "
          f"({dw_ratio:.2e}), padding dw zero {pad_zero}; poisoned outputs (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"K1 or K2 at the {where} route's shape disagrees with its plain version")
    del out, dh, dw
    lib_a = torch.sparse_csr_tensor(csr.indptr, csr.cols[:e], w[:e], size=(n, n), check_invariants=False)
    lib_t = torch.sparse_csr_tensor(csr_t.indptr, csr_t.cols[:e], w_t[:e], size=(n, n), check_invariants=False)
    per = {}
    for key, fn, plain, libs, bound in (
        ("K1", lambda: SK.spmm_rowmask(csr, w, x, stream_dtype=stream),
         lambda: SK.spmm_rowmask_plain(csr, w, x, stream), (("sparse.mm", lambda: torch.sparse.mm(lib_a, x)),),
         k1_bound(n, e, f, weighted=True)),
        ("K2", lambda: SK.spmm_rowmask_bwd(csr_t, w_t, g, fs, stream_dtype=stream),
         lambda: SK.spmm_rowmask_bwd_plain(csr_t, w_t, g, fs, stream),
         (("sparse.mm", lambda: torch.sparse.mm(lib_t, g)),
          ("sampled_addmm", lambda: torch.sparse.sampled_addmm(lib_t, fs, g.t(), beta=0.0))), k2_bound(n, e, f)),
    ):
        ms = cuda_ms(fn, iters=50, warmup=5)
        plain_ms = cuda_ms(plain, iters=5, warmup=1)
        lib = {}
        for lname, lfn in libs:
            try:  # a timed yardstick only; the port never calls it
                lib[lname] = cuda_ms(lfn, iters=20, warmup=2)
            except RuntimeError as exc:
                print(f"library yardstick {lname} unavailable: {exc}")
                lib[lname] = None
        lib_ms = None if None in lib.values() else sum(lib.values())
        bound_ms, bound_by, nbytes, ops = bound
        per[key] = {"where": where, "F": f, "E": e, "N": n, "stream": name, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms, "library_parts_ms": lib, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bytes": nbytes, "ops": ops,
                    "max_abs_err": k1_err if key == "K1" else max(dh_err, dw_err)}
        print(f"temporal-{key.lower()}-main {where} F={f}: {ms:.4f} ms back to back (plain {plain_ms:.3f} ms, "
              f"library {lib} ms, bound {bound_ms:.4f} ms by {bound_by})")
    return per


@timed_phase
def phase_static_temporal_checks(dev, args, run):
    """The Windmill kernel route against the dense route and against
    itself, from the same seed's parameters: the first window of the kernel
    run's warm epoch (1000 timesteps of BPTT) against the same window on the
    dense route, and against it with ``--remat``, loss and gradients
    compared; K1 counted 6 x the window's timesteps with remat (the forward
    recomputed) and K2 3 x; then K1 and K2 at the route's shapes (f32
    streams) against their plain versions (``k1_k2_at_temporal_shape``)."""
    from stgraph_tpu_torch.drivers.static_temporal_tgcn import StaticTemporalTrainer

    d, base, kernel = run["data"], run["trainer"], run["warm_records"]

    def fresh(impl, remat=False):
        return StaticTemporalTrainer(d, STATIC_F, STATIC_H, base.window, STATIC_LR, impl, remat, dev, args.seed)

    t0 = time.perf_counter()
    w0 = len(base.window_range(0))
    reset_counts()
    dense = window_records(fresh("dense"), windows=1, step=False)
    check(read_counts() == only(), "the dense window launched a kernel")
    loss_err, grad_err = compare_windows(kernel[:1], dense)
    ok = loss_err <= STATIC_LOSS_TOL and max(grad_err.values()) <= STATIC_GRAD_TOL
    print(f"static-temporal-check windmill_large: the warm epoch's first window ({w0} timesteps), kernel route vs "
          f"dense: loss err/|loss| {loss_err:.2e} (tol {STATIC_LOSS_TOL:g}), worst gradient err/max "
          f"{max(grad_err.values()):.2e} (tol {STATIC_GRAD_TOL:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"the Windmill kernel route disagrees with the dense route: loss {loss_err}, gradients {grad_err}")
    remat_tr = fresh("kernel", remat=True)
    reset_counts()
    remat = window_records(remat_tr, windows=1, step=False)
    remat_counts = read_counts()
    r_loss_err, r_grad_err = compare_windows(remat, kernel[:1])
    ok = (r_loss_err <= STATIC_LOSS_TOL and max(r_grad_err.values()) <= STATIC_GRAD_TOL
          and remat_counts == only(K1=6 * w0, K2=3 * w0))
    print(f"static-temporal-check windmill_large --remat, first window ({w0} timesteps): launches {remat_counts} "
          f"(expected 6 x {w0} K1, 3 x {w0} K2: an epoch 6T K1 and 3T K2); vs no remat: loss err/|loss| "
          f"{r_loss_err:.2e}, worst gradient err/max {max(r_grad_err.values()):.2e} {'ok' if ok else 'FAIL'}")
    check(ok, f"--remat disagrees with no remat: counts {remat_counts}, loss {r_loss_err}, gradients {r_grad_err}")

    def one_timestep():
        remat_tr.opt.zero_grad(set_to_none=True)
        _, loss = remat_tr._timestep(remat_tr.zero_hidden(), remat_tr.feats[0], remat_tr.ys[0])
        loss.backward()

    per = k1_k2_at_temporal_shape("windmill_large", one_timestep, None)
    return {"kernel_vs_dense": {"window_timesteps": w0, "loss_err": loss_err, "grad_err": grad_err},
            "remat": {"window_timesteps": w0, "launches": remat_counts, "loss_err": r_loss_err,
                      "grad_err": r_grad_err},
            "per_launch": per, "s": time.perf_counter() - t0}


@timed_phase
def phase_dynamic_temporal(dev, args, workdir, name):
    """``benchmarking/dynamic-temporal-tgcn/train.py --type naive|delta|
    delta-scan`` on the port (``drivers.dynamic_temporal_tgcn``) on
    ``name`` at ``DYN_TEMPORAL_WIDTHS``: for each type 1 warm and 4 timed
    epochs (England-COVID's 129 nodes take the dense route, no kernel; the
    wiki-talk-shaped stream's 20,000 take K1 3T forward and K2 3T backward:
    unweighted, the lowering still weights each edge by its source's norm),
    the graph side alone (``updates_only``:
    snapshots, or apply_delta and edge_store_to_csr) and a profile of one
    epoch; the three types' loss trajectories (the same seed, so the same
    negatives) agree to ``DYN_TYPES_TOL``. On the kernel route, K1 and K2
    with the arguments of the naive type's first timestep (its stream's
    rule: bf16 at the wiki-talk-shaped stream's 200,000 edges a snapshot)
    against their plain versions (``k1_k2_at_temporal_shape``)."""
    from stgraph_tpu_torch.drivers.dynamic_temporal_tgcn import link_loss
    from stgraph_tpu_torch.ops import spmm_cuda

    lags, hidden = DYN_TEMPORAL_WIDTHS[name]
    runs, per_launch = {}, None
    for kind in DYN_TEMPORAL_TYPES:
        t0 = time.perf_counter()
        edge_lists, weight_lists, tr = dtdg_trainer(dev, name, workdir, kind, lags, hidden, args.seed)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        steps = tr.steps

        def epoch():
            loss = tr.epoch().item()
            torch.cuda.synchronize()
            return loss

        t = time.perf_counter()
        losses = [epoch()]
        warm_s = time.perf_counter() - t
        reset_counts()
        times, per_epoch = [], []
        for _ in range(DYN_TEMPORAL_EPOCHS):
            before = read_counts()
            t = time.perf_counter()
            losses.append(epoch())
            times.append(time.perf_counter() - t)
            per_epoch.append({k: v - before[k] for k, v in read_counts().items()})
        counts = read_counts()
        kernel = not dense_route(tr.num_nodes)
        expected = only(K1=3 * steps, K2=3 * steps) if kernel else only()
        check(all(c == expected for c in per_epoch), f"a {name} {kind} epoch launched {per_epoch}, expected {expected}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"the {name} {kind} loss: {losses}")

        def updates():
            tr.updates_only()
            torch.cuda.synchronize()

        updates()
        t = time.perf_counter()
        updates()
        update_s = time.perf_counter() - t
        profile = phase_profile(epoch, f"one {name} {kind} epoch")
        print(f"dynamic-temporal {name} --type {kind}: N={tr.num_nodes}, T={steps}, F={lags} H={hidden}, "
              f"{'kernel' if kernel else 'dense'} route, build {tr.build_s:.3f} s (set-up {setup_s:.2f} s, update "
              f"counters {tr.store.get_fwd_graph_time():.4f} / {tr.store.get_bwd_graph_time():.4f} s); warm "
              f"{warm_s:.3f} s; {DYN_TEMPORAL_EPOCHS} epochs, s {[round(v, 4) for v in times]}, losses "
              f"{[round(v, 5) for v in losses]}; graph side alone {update_s:.4f} s an epoch; launches an epoch "
              f"{per_epoch[0]}; idle share {profile['idle_share']:.3f}")
        runs[kind] = {"n": tr.num_nodes, "timesteps": steps, "lags": lags, "hidden": hidden,
                      "route": "kernel" if kernel else "dense", "build_s": tr.build_s, "setup_s": setup_s,
                      "warm_s": warm_s, "epoch_s": times, "losses": losses, "update_s": update_s,
                      "launches": counts, "launches_per_epoch": per_epoch, "profile": profile}
        if kernel and kind == "naive":
            stream = spmm_cuda._stream_dtype(tr.store.get_graph(lags), torch.float32)

            def one_timestep():
                tr.opt.zero_grad(set_to_none=True)
                csr, w, rows, cols, mask = next(tr.timesteps())
                h = tr.model(csr, tr.xs[0], edge_weight=w, hidden=torch.zeros(tr.num_nodes, hidden, device=dev))
                link_loss(h, rows, cols, mask, *tr.negatives(0, rows.shape[0])).backward()

            per_launch = k1_k2_at_temporal_shape(name, one_timestep, stream)
        del tr
    ref = runs["naive"]["losses"]
    agree = {kind: max(abs(a - b) for a, b in zip(r["losses"], ref)) for kind, r in runs.items()}
    ok = max(agree.values()) <= DYN_TYPES_TOL
    print(f"dynamic-temporal-check {name}: the types' loss trajectories over {DYN_TEMPORAL_EPOCHS + 1} epochs against "
          f"naive's, worst |diff| {agree} (tol {DYN_TYPES_TOL:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{name}: the dynamic types disagree: {agree}")
    return {"runs": runs, "types_max_abs_diff": agree, "per_launch": per_launch}


def update_syncs(fn) -> dict:
    """The host's waits at the values it reads from the device over one
    call of ``fn`` (a pma-scan epoch's updates: the rebuild flags), from
    the profiler's host events of ``aten::_local_scalar_dense``: each one
    spans the copy and the wait for the device work queued before it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    waits = [(e.end_ns() - e.start_ns()) / 1e3 for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU and e.name() == "aten::_local_scalar_dense"]
    return {"reads": len(waits), "wait_ms": sum(waits) / 1e3,
            "wait_us_per_read": sum(waits) / max(len(waits), 1), "wait_us_max": max(waits, default=0.0)}


@timed_phase
def phase_pma_scan(dev, args, workdir, name):
    """``benchmarking/dynamic-temporal-tgcn/train.py --type pma-scan`` on the
    port (``drivers.dynamic_temporal_tgcn``) on ``name`` at
    ``DYN_TEMPORAL_WIDTHS``: the PMA pair (chunks of 256 slots) built from
    ``snapshot_store(lags - 1)``'s live slots, one ``apply_delta_pair`` a
    timestep (one host read of a flag a store), TGCN over the pair. 1 warm
    and 4 timed epochs, each launching 6T K6 and 3T K7; the epoch time, the
    graph side alone, the rebuilds an epoch and a profile (idle share).
    Then the hidden state at every timestep of an epoch against delta-scan's
    (the same parameters and graph sequence, an f32 stream on both) within
    ``PMA_HIDDEN_TOL``, and K6 on pair.fwd and pair.bwd and K7 on pair.fwd
    at this path's shapes against their plain versions into NaN-poisoned
    outputs, timed beside them and their bounds."""
    from stgraph_tpu_torch.graph.pma_store import apply_delta_pma
    from stgraph_tpu_torch.ops import spmm_cuda
    from stgraph_tpu_torch.ops.rowid_kernels import dyn_degree, dyn_degree_plain, spmm_rowid, spmm_rowid_plain

    lags, hidden = DYN_TEMPORAL_WIDTHS[name]
    t0 = time.perf_counter()
    _, _, tr = dtdg_trainer(dev, name, workdir, "pma-scan", lags, hidden, args.seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n, steps, slots = tr.num_nodes, tr.steps, tr.pair0.fwd.capacity
    chunks, chunk = tr.pair0.fwd.rows.shape

    def epoch():
        loss = tr.epoch().item()
        torch.cuda.synchronize()
        return loss

    t = time.perf_counter()
    losses = [epoch()]
    warm_s = time.perf_counter() - t
    reset_counts()
    times, per_epoch, rebuilds = [], [], []
    for _ in range(DYN_TEMPORAL_EPOCHS):
        before, rb = read_counts(), apply_delta_pma.rebuilds
        t = time.perf_counter()
        losses.append(epoch())
        times.append(time.perf_counter() - t)
        per_epoch.append({k: v - before[k] for k, v in read_counts().items()})
        rebuilds.append(apply_delta_pma.rebuilds - rb)
    counts = read_counts()
    expected = only(K6=6 * steps, K7=3 * steps)
    check(all(c == expected for c in per_epoch), f"a {name} pma-scan epoch launched {per_epoch}, expected {expected}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"the {name} pma-scan loss: {losses}")

    def updates():
        tr.updates_only()
        torch.cuda.synchronize()

    updates()
    t = time.perf_counter()
    updates()
    update_s = time.perf_counter() - t
    sync = update_syncs(updates)
    check(sync["reads"] == 2 * steps, f"{name}: an epoch's updates read {sync['reads']} values on the host, "
          f"expected one rebuild flag a store a timestep ({2 * steps})")
    profile = phase_profile(epoch, f"one {name} pma-scan epoch")

    # the hidden states against delta-scan's, from the same parameters
    ref = dtdg_trainer(dev, name, workdir, "delta-scan", lags, hidden, args.seed)[2]
    ref.model.load_state_dict(tr.model.state_dict())
    limit = spmm_cuda._BF16_STREAM_MIN_EDGES
    spmm_cuda._BF16_STREAM_MIN_EDGES = 1 << 62
    try:
        hs, hs_ref = [], []
        with torch.no_grad():
            tr.epoch_loss(hs)
            ref.epoch_loss(hs_ref)
    finally:
        spmm_cuda._BF16_STREAM_MIN_EDGES = limit
    hidden_err = max((a - b).abs().max().item() for a, b in zip(hs, hs_ref))
    check(len(hs) == len(hs_ref) == steps and hidden_err <= PMA_HIDDEN_TOL,
          f"{name}: pma-scan's hidden states differ from delta-scan's by {hidden_err}")
    del ref, hs, hs_ref

    # K6 and K7 at this path's shapes: the stores after the last timestep
    pair = tr.pair0
    for t in range(steps):
        pair = tr.update(pair, t)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    kernels = {}
    with torch.no_grad():
        for side, st in (("fwd", pair.fwd), ("bwd", pair.bwd)):
            rows, cols, w = st.flatten()
            x = torch.randn(n, hidden, device=dev, generator=gen)
            out = poisoned_call((n, hidden), lambda: spmm_rowid(rows, cols, w, x, n))
            ref_out = spmm_rowid_plain(rows, cols, w, x, n)
            err = (out - ref_out).abs()
            ratio = _err_over_mass(err, spmm_rowid_plain(rows, cols, None if w is None else w.abs(), x.abs(), n))
            check(ratio <= KERNEL_TOL, f"{name}: K6 on the PMA pair.{side} disagrees: err/sum|terms| {ratio}")
            live = int((rows < n).sum())
            bound_ms, bound_by, _, _ = rowid_bounds(slots, n, hidden, live, weighted=w is not None)[0]
            lib_a = rowid_csr(rows, cols, w, n)
            try:  # a timed yardstick only; the port never calls it
                lib_err = (torch.sparse.mm(lib_a, x) - ref_out).abs().max().item()
                lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, x), iters=20, warmup=2)
            except RuntimeError as exc:
                print(f"library yardstick sparse.mm unavailable: {exc}")
                lib_err, lib_ms = None, None
            kernels[f"K6_{side}"] = {"N": n, "slots": slots, "live": live, "F": hidden, "weighted": w is not None,
                                     "max_abs_err": err.max().item(), "err_over_mass": ratio,
                                     "ms": cuda_ms(lambda: spmm_rowid(rows, cols, w, x, n), iters=50, warmup=3),
                                     "plain_ms": cuda_ms(lambda: spmm_rowid_plain(rows, cols, w, x, n), iters=3),
                                     "library_ms": lib_ms, "library_max_abs_err": lib_err,
                                     "bound_ms": bound_ms, "bound_by": bound_by}
            del lib_a
        rows = pair.fwd.flatten()[0]
        den = poisoned_call((n,), lambda: dyn_degree(rows, None, n))
        check(torch.equal(den, dyn_degree_plain(rows, None, n)), f"{name}: K7 on the PMA pair.fwd is not bit-equal")
        bound_ms, bound_by, _, _ = rowid_bounds(slots, n, 1, slots, weighted=False)[1]  # count mode: no w read
        try:  # a timed yardstick only; the port never calls it
            lib_equal = torch.equal(torch.bincount(rows, minlength=n + 1)[:n].float(), den)
            lib_ms = cuda_ms(lambda: torch.bincount(rows, minlength=n + 1), iters=50, warmup=3)
        except RuntimeError as exc:
            print(f"library yardstick bincount unavailable: {exc}")
            lib_ms, lib_equal = None, None
        kernels["K7"] = {"N": n, "slots": slots, "max_abs_err": 0.0, "bound_ms": bound_ms, "bound_by": bound_by,
                         "ms": cuda_ms(lambda: dyn_degree(rows, None, n), iters=100, warmup=3),
                         "plain_ms": cuda_ms(lambda: dyn_degree_plain(rows, None, n), iters=3),
                         "library_ms": lib_ms, "library_equal": lib_equal}
    print(f"pma-scan {name}: N={n}, T={steps}, F={lags} H={hidden}, {chunks} chunks of {chunk} slots (set-up "
          f"{setup_s:.2f} s); warm {warm_s:.3f} s; {DYN_TEMPORAL_EPOCHS} epochs, s {[round(v, 4) for v in times]}, "
          f"losses {[round(v, 5) for v in losses]}; rebuilds an epoch {rebuilds} of {2 * steps} store updates; "
          f"graph side alone {update_s:.4f} s an epoch, of which the host waits {sync['wait_ms']:.2f} ms at its "
          f"{sync['reads']} flag reads (mean {sync['wait_us_per_read']:.1f} us, the device work queued before each "
          f"included); "
          f"launches an epoch {per_epoch[0]}; idle share "
          f"{profile['idle_share']:.3f}; hidden states vs delta-scan max |diff| {hidden_err:.2e} (tol "
          f"{PMA_HIDDEN_TOL:g}); K6 fwd {kernels['K6_fwd']['ms'] * 1e3:.1f} us (plain "
          f"{kernels['K6_fwd']['plain_ms'] * 1e3:.1f} us, sparse.mm {kernels['K6_fwd']['library_ms']} ms, bound "
          f"{kernels['K6_fwd']['bound_ms'] * 1e3:.2f} us), K7 {kernels['K7']['ms'] * 1e3:.1f} us (plain "
          f"{kernels['K7']['plain_ms'] * 1e3:.1f} us, bincount {kernels['K7']['library_ms']} ms, bound "
          f"{kernels['K7']['bound_ms'] * 1e3:.2f} us), no NaN")
    return {"n": n, "timesteps": steps, "lags": lags, "hidden": hidden, "chunks": chunks, "chunk_size": chunk,
            "setup_s": setup_s, "warm_s": warm_s, "epoch_s": times, "losses": losses, "update_s": update_s,
            "host_syncs_per_timestep": 2, "update_sync": sync, "rebuilds_per_epoch": rebuilds, "store_updates_per_epoch": 2 * steps,
            "launches": counts, "launches_per_epoch": per_epoch, "profile": profile,
            "hidden_max_abs_diff_vs_delta_scan": hidden_err, "kernels": kernels}


@contextlib.contextmanager
def world_of_one(backend):
    """A one-process group on ``backend`` for the phase inside, destroyed
    after it."""
    import socket

    from stgraph_tpu_torch.parallel import launch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    launch.initialize(f"127.0.0.1:{port}", 1, 0, backend=backend)
    try:
        yield
    finally:
        launch.shutdown()


def dist_params(dims, rng, dev):
    """benchmarking/dist/train.py's parameters: w_i ~ 0.1 N(0, 1), b_i = 0,
    drawn from ``rng`` in its order."""
    params = {f"w{i}": torch.from_numpy((rng.standard_normal((a, b)) * 0.1).astype(np.float32))
              for i, (a, b) in enumerate(zip(dims[:-1], dims[1:]))}
    params.update({f"b{i}": torch.zeros(b) for i, b in enumerate(dims[1:])})
    return {k: v.to(dev).requires_grad_() for k, v in params.items()}


def dist_gcn_loss(mesh, dg, x, y, norm, params, impl):
    """``build_step``'s model and loss on this rank's shard: each layer
    ``(h @ w + b) * norm``, ``dist_spmm`` and ``* norm``, ReLU between;
    softmax cross-entropy summed here and divided by the P·Ns padded rows,
    so that the ranks' losses add up to ``train.py``'s mean. Returns (loss,
    logits)."""
    from stgraph_tpu_torch.parallel import dist_spmm

    layers = len(params) // 2
    h = x
    for i in range(layers):
        h = (h @ params[f"w{i}"] + params[f"b{i}"]) * norm
        h = dist_spmm(mesh, dg, h, impl=impl) * norm
        if i < layers - 1:
            h = torch.relu(h)
    return torch.nn.functional.cross_entropy(h, y, reduction="sum") / dg.padded_nodes, h


def dist_train_data(seed, nodes, edges, feat, hidden, layers, classes):
    """``benchmarking/dist/train.py``'s synthetic graph and parameters
    (``run_once`` without ``--dataset``), drawn from ``seed`` in its order:
    power-law sources, uniform destinations, features, labels, the norm,
    then the weights."""
    rng = np.random.default_rng(seed)
    src = (nodes * rng.power(2.5, edges)).astype(np.int64) % nodes
    dst = rng.integers(0, nodes, edges)
    feats = rng.standard_normal((nodes, feat)).astype(np.float32)
    labels = rng.integers(0, classes, nodes)
    norm = (rng.random((nodes, 1)) + 0.5).astype(np.float32)
    return src, dst, feats, labels, norm, rng, [feat] + [hidden] * (layers - 1) + [classes]


def dist_batch(mesh, dg, data):
    """This rank's shards of ``train.py``'s features, labels (padded with 0,
    as ``run_once`` pads them) and norm."""
    from stgraph_tpu_torch.parallel import shard_node_array

    _, _, feats, labels, norm, _, _ = data
    y = np.zeros(dg.padded_nodes, np.int64)
    y[: len(labels)] = labels
    return tuple(shard_node_array(mesh, torch.from_numpy(a), dg) for a in (feats, y, norm))


def dist_step_grads(mesh, dg, batch, params, impl):
    """One training step's loss (summed over the ranks) and every parameter's
    gradient after ``reduce_replicated_grads``, on this rank."""
    from stgraph_tpu_torch.parallel import reduce_replicated_grads
    from stgraph_tpu_torch.parallel.mesh import staged_collective

    for p in params.values():
        p.grad = None
    loss, _ = dist_gcn_loss(mesh, dg, *batch[:2], batch[2], params, impl)
    loss.backward()
    reduce_replicated_grads(mesh, params)
    total = staged_collective(torch.distributed.all_reduce, loss.detach().clone(), None)
    return float(total), {k: p.grad.detach().clone() for k, p in params.items()}


def traced_agreement(out, csr, w, x, heads, den=None):
    """K1's shard mode against its plain version on the same inputs (f32
    stream): per output (max_abs_err, worst err / sum|terms|, max |plain|)."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_plain

    block = PLAIN_EDGE_BLOCK
    absw = None if w is None else w.abs()
    if den is None:
        ref = spmm_rowmask_plain(csr, w, x, torch.float32, block, heads=heads)
        mass = spmm_rowmask_plain(csr, absw, x.abs(), torch.float32, block, heads=heads)
        return _stats([out], [ref], [mass])
    ref, ref_den = spmm_rowmask_plain(csr, w, x, torch.float32, block, heads=heads, with_denom=True)
    mass, mass_den = spmm_rowmask_plain(csr, absw, x.abs(), torch.float32, block, heads=heads, with_denom=True)
    return _stats([out, den], [ref, ref_den], [mass, mass_den])


@timed_phase
def phase_dist_k1_traced_checks(dev, rng, n=200_000, e=4_000_000, hub_deg=300_000):
    """K1's shard mode (``spmm_rowmask_traced``) and K2 on a rectangular
    transpose against their plain versions, on one shard of a 4-way
    partition of a power-law check graph (a 300k-edge hub row): the
    interior CSR (square), the frontier CSR (its halo table taller than the
    shard) and the local ``[local | halo]`` CSR; unweighted, weighted one
    head and 4 x 32 weighted with the denominator, all f32 streams; and the
    empty frontier of a one-shard partition, which must come out 0."""
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask_bwd, spmm_rowmask_bwd_plain, spmm_rowmask_traced
    from stgraph_tpu_torch.parallel import partition_edges

    src = (n * rng.power(2.5, e)).astype(np.int64) % n
    dst = rng.integers(0, n, e)
    dst[:hub_deg] = 12_345
    t = time.perf_counter()
    dg = partition_edges(src, dst, n, DIST_CHECK_SHARDS)
    part_s = time.perf_counter() - t
    sh = dg.shard(0, dev)  # the hub's shard
    ns, halo = dg.nodes_per_shard, dg.halo_total
    check(halo > ns, f"the check partition's halo ({halo} rows) is not taller than a shard ({ns})")

    def rand(*shape, positive=False):
        a = rng.random(shape) if positive else rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    def slot_w(csr, heads):
        w = rand(csr.capacity, heads, positive=heads > 1)
        w[csr.num_edges:] = 0.0
        return w.reshape(-1) if heads == 1 else w

    h4, f4 = DIST_GAT_TILING
    cases = [("interior", sh.interior_csr, ns, 64, 1, False), ("frontier", sh.frontier_csr, halo, 64, 1, False),
             ("interior", sh.interior_csr, ns, 47, 1, True), ("frontier", sh.frontier_csr, halo, 47, 1, True),
             ("local", sh.local_csr, ns + halo, h4 * f4, h4, True)]
    results, worst = [], {"K1_traced": 0.0, "K2": 0.0}
    for name, csr, rows, width, heads, weighted in cases:
        x = rand(rows, width)
        w = slot_w(csr, heads) if weighted else None
        out, den = poisoned_call((csr.num_nodes, width), lambda: spmm_rowmask_traced(csr, w, x, heads=heads,
                                                                                     with_denom=heads > 1))
        torch.cuda.synchronize()
        stats = traced_agreement(out, csr, w, x, heads, den)
        r = max(s[1] for s in stats)
        ok = r <= KERNEL_TOL
        label = f"{name} ({csr.num_nodes} x {csr.num_cols}, {csr.num_edges} edges) " + (
            f"{heads} x {width // heads}" if heads > 1 else f"F={width}") + (" weighted" if weighted else "")
        print(f"dist-k1-traced-check {label}: max_abs_err {stats[0][0]:.3e} (err/sum|terms| {r:.2e}, max |plain| "
              f"{stats[0][2]:.2f}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"K1's shard mode disagrees with its plain version: {label}")
        worst["K1_traced"] = max(worst["K1_traced"], *(s[0] for s in stats))
        results.append({"kernel": "K1_traced", "csr": name, "H": heads, "F": width // heads, "weighted": weighted,
                        "rows": csr.num_nodes, "cols": csr.num_cols, "edges": csr.num_edges,
                        "max_abs_err": stats[0][0], "err_over_mass": r})
        # K2 on the rectangular transpose: dh over the table's rows, dw per edge
        if weighted:
            csr_t = csr.transpose()
            perm_t = csr.edge_perms()[0].long()
            w_t = w.index_select(0, perm_t)
            g = rand(csr.num_nodes, width)
            dh, dw = spmm_rowmask_bwd(csr_t, w_t, g, x, heads=heads)
            torch.cuda.synchronize()
            block = K2_PLAIN_EDGE_BLOCK
            refs = spmm_rowmask_bwd_plain(csr_t, w_t, g, x, torch.float32, block, heads=heads)
            masses = spmm_rowmask_bwd_plain(csr_t, w_t.abs(), g.abs(), x.abs(), torch.float32, block, heads=heads)
            (ha, hr, _), (wa, wr, _) = _stats([dh, dw], refs, masses)
            ok = max(hr, wr) <= KERNEL_TOL and not dw[csr_t.num_edges:].any().item()
            print(f"dist-k2-check {name} transpose ({csr_t.num_nodes} x {csr_t.num_cols}): dh max_abs_err {ha:.3e} "
                  f"({hr:.2e}), dw max_abs_err {wa:.3e} ({wr:.2e}) (tol {KERNEL_TOL:g}) {'ok' if ok else 'FAIL'}")
            check(ok, f"K2 on the rectangular {name} transpose disagrees with its plain version")
            worst["K2"] = max(worst["K2"], ha, wa)
            results.append({"kernel": "K2", "csr": name + " transpose", "H": heads, "F": width // heads,
                            "dh_err_over_mass": hr, "dw_err_over_mass": wr})
            del csr_t, w_t, g, dh, dw, refs, masses
        del x, w, out, den
    one = partition_edges(src[:1000] % 1000, dst[:1000] % 1000, 1000, 1).shard(0, dev)
    out, _ = spmm_rowmask_traced(one.frontier_csr, None, torch.ones(one.frontier_csr.num_cols, 64, device=dev))
    torch.cuda.synchronize()
    ok = one.frontier_csr.num_edges == 0 and tuple(out.shape) == (1000, 64) and not out.any().item()
    print(f"dist-k1-traced-check empty frontier (P = 1, {one.frontier_csr.capacity} padding slots, a halo of "
          f"{one.frontier_csr.num_cols} rows): zeros {'ok' if ok else 'FAIL'}")
    check(ok, "K1's shard mode did not write zeros over an empty frontier")
    return {"graph": {"n": n, "e": e, "hub_deg": hub_deg, "shards": DIST_CHECK_SHARDS, "nodes_per_shard": ns,
                      "halo_total": halo, "partition_s": part_s}, "cases": results, "max_abs_err": worst}


def dist_kernel_timings(csr, f, dev, traced):
    """One K1 launch at the main path's shapes: K1's shard mode over the
    shard CSR (``traced``) or K1 over its transpose, f32, unweighted; the
    plain version and ``torch.sparse.mm`` on the same CSR timed beside it."""
    from stgraph_tpu_torch.ops.spmm_kernels import K1_CHUNK, spmm_rowmask, spmm_rowmask_plain, spmm_rowmask_traced

    n, e = csr.num_nodes, csr.num_edges
    gen = torch.Generator(device=dev).manual_seed(f)
    x = torch.randn(csr.num_cols, f, device=dev, generator=gen)
    if traced:
        run = lambda: spmm_rowmask_traced(csr, None, x)  # noqa: E731
    else:
        run = lambda: spmm_rowmask(csr, None, x, stream_dtype=torch.float32)  # noqa: E731
    out, _ = poisoned_call((n, f), run)
    torch.cuda.synchronize()
    (err, ratio, max_ref), = traced_agreement(out, csr, None, x, 1)
    check(ratio <= KERNEL_TOL, f"K1 ({'shard mode' if traced else 'transpose'}) at F={f} disagrees: {ratio}")
    del out
    ms = cuda_ms(run, iters=10, warmup=2)
    plain_ms = cuda_ms(lambda: spmm_rowmask_plain(csr, None, x, torch.float32, edge_block=PLAIN_EDGE_BLOCK),
                       iters=2, warmup=1)
    lib_a = torch.sparse_csr_tensor(csr.indptr, csr.cols[:e], torch.ones(e, device=dev), size=(n, csr.num_cols),
                                    check_invariants=False)
    try:  # a timed yardstick only; the port never calls it
        lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, x), iters=5, warmup=1)
    except RuntimeError as exc:
        print(f"library yardstick unavailable at F={f}: {exc}")
        lib_ms = None
    bound_ms, bound_by, nbytes, ops = k1_bound(n, e, f, weighted=False)
    where = "shard forward" if traced else "shard transpose"
    print(f"dist-k1-main {where} F={f}: {ms:.3f} ms (plain {plain_ms:.1f} ms, torch.sparse.mm {lib_ms} ms, bound "
          f"{bound_ms:.3f} ms by {bound_by}); max_abs_err {err:.3e} (max |plain| {max_ref:.2f}), worst "
          f"err/sum|terms| {ratio:.2e}")
    return {"where": where, "F": f, "H": 1, "E": e, "N": n, "stream": "f32",
            "longest_item": longest_item(csr, K1_CHUNK["one_head"]),
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops, "max_abs_err": err, "err_over_mass": ratio}


@timed_phase
def phase_ogbn_reorder(dev, args, workdir, base, smi):
    """ogbn-reorder: the loader's locality order at full size, its working
    sets, and K1 (forward and transpose, unweighted, F = 128, bf16 stream)
    on both orders; K1 held against its plain version on the reordered
    graph."""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.graph import StaticGraph
    from stgraph_tpu_torch.graph import reorder as R
    from stgraph_tpu_torch.ops.spmm_kernels import spmm_rowmask

    found = R.locality_order
    order_s = []

    def timed_order(*a):
        t = time.perf_counter()
        order = found(*a)
        order_s.append(time.perf_counter() - t)
        return order

    R.locality_order = timed_order  # the loader imports it from the module when it reorders
    try:
        t = time.perf_counter()
        data = OgbNodeDataLoader(root=workdir, scale=args.scale, seed=args.seed, reorder=True)
        load_s = time.perf_counter() - t
    finally:
        R.locality_order = found
    n = data.gdata["num_nodes"]
    order = data.node_order
    check(len(order_s) == 1 and np.array_equal(np.sort(order), np.arange(n)),
          "the reordering loader gave no permutation of the nodes")
    t = time.perf_counter()
    graph = StaticGraph(data.get_edges(), None, n, device=dev)
    _ = graph.bwd_csr
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    del data
    rec = {"N": n, "E": graph.fwd_csr.num_edges, "loader_s": load_s, "reorder_s": order_s[0],
           "graph_build_s": build_s, "working_set_256B": {}, "k1": []}
    for name, g in (("base", base["graph"]), ("reordered", graph)):
        csr = g.fwd_csr
        _, rows, cols, _ = csr.host_arrays()  # the edges in (dst, src) order
        t = time.perf_counter()
        rec["working_set_256B"][name] = R.gather_working_set(rows[:csr.num_edges], cols[:csr.num_edges], n,
                                                             row_bytes=256)
        rec.setdefault("working_set_s", {})[name] = time.perf_counter() - t
    gen = torch.Generator(device=dev).manual_seed(args.seed + 41)
    x = torch.randn(n, 128, device=dev, generator=gen)
    xs = {"base": x, "reordered": x[torch.from_numpy(order.astype(np.int64)).to(dev)]}  # the same rows, relabelled
    bf16 = torch.bfloat16
    reset_counts()
    with torch.inference_mode():
        for name, g in (("base", base["graph"]), ("reordered", graph)):
            for where, csr in (("forward", g.fwd_csr), ("transpose", g.bwd_csr)):
                run = lambda: spmm_rowmask(csr, None, xs[name], stream_dtype=bf16)  # noqa: E731
                out, _ = poisoned_call((n, 128), run)
                torch.cuda.synchronize()
                err = ratio = None
                if name == "reordered":
                    err, ratio, _ = k1_agreement(out, csr, None, xs[name], bf16, PLAIN_EDGE_BLOCK)
                    check(ratio <= KERNEL_TOL, f"K1 on the reordered graph ({where}) disagrees: {ratio}")
                del out
                ms = cuda_ms(run, iters=10, warmup=2)
                e = csr.num_edges
                lib_a = torch.sparse_csr_tensor(csr.indptr, csr.cols[:e], torch.ones(e, device=dev), size=(n, n),
                                                check_invariants=False)
                try:  # a timed yardstick only; the port never calls it
                    lib_ms = cuda_ms(lambda: torch.sparse.mm(lib_a, xs[name]), iters=5, warmup=1)
                except RuntimeError as exc:
                    print(f"library yardstick unavailable: {exc}")
                    lib_ms = None
                del lib_a
                bound_ms = k1_bound(n, e, 128, weighted=False)[0]
                rec["k1"].append({"order": name, "where": where, "F": 128, "stream": "bf16", "weighted": False,
                                  "ms": ms, "library_ms": lib_ms, "bound_ms": bound_ms, "max_abs_err": err,
                                  "err_over_mass": ratio})
                print(f"ogbn-reorder K1 {name} {where} F=128 bf16 unweighted: {ms:.3f} ms (torch.sparse.mm "
                      f"{lib_ms} ms, bound {bound_ms:.3f} ms)" + ("" if err is None else
                      f"; max_abs_err {err:.3e}, worst err/sum|terms| {ratio:.2e}") + f" [{smi}]")
    counts = read_counts()
    check(counts == only(K1=counts["K1"]), f"the reorder phase launched {counts}")
    ws = rec["working_set_256B"]
    print(f"ogbn-reorder: N={n} E={rec['E']}: loader with reorder {load_s:.1f} s (the reorder {order_s[0]:.1f} s), "
          f"graph build {build_s:.1f} s; working set at 256 B rows {ws['base'] / 2**20:.1f} MiB (loader's "
          f"order) -> {ws['reordered'] / 2**20:.1f} MiB (reordered) [{smi}]")
    del graph, xs, x
    torch.cuda.empty_cache()
    return rec


@timed_phase
def phase_dist_gcn_training(dev, args, base):
    """dist-gcn-training: ``benchmarking/dist/train.py --dataset
    ogbn-products`` on the port at world size 1 over NCCL, on the graph the
    GCN phases built: the partition, 1 warm and 5 timed Adam(1e-2) steps
    (3 K1 shard-mode launches and 3 K1 launches on the shard transposes a
    step; every loss finite), the loss against the single-device step on
    the global CSR, a
    profile of a step, and K1's shard mode and K1 on the transpose timed at
    the step's shapes."""
    from stgraph_tpu_torch.ops.spmm_cuda import _RowmaskSpmm
    from stgraph_tpu_torch.parallel import make_mesh, partition_edges, reduce_replicated_grads, shard_node_array
    from stgraph_tpu_torch.parallel.halo import exchange as halo_exchange

    graph, feats, labels = base["graph"], base["feats"], base["labels"]
    csr = graph.fwd_csr
    _, rows, cols, _ = csr.host_arrays()
    n, e = csr.num_nodes, csr.num_edges
    with world_of_one("nccl"):
        mesh = make_mesh()
        check(torch.distributed.get_backend() == "nccl", "the world of one is not on NCCL")
        t = time.perf_counter()
        dg = partition_edges(cols[:e], rows[:e], n, 1)
        partition_s = time.perf_counter() - t
        t = time.perf_counter()
        shard = dg.shard(0, dev)
        interior, frontier = shard.interior_csr, shard.frontier_csr
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t
        print(f"dist partition: N={n} E={e} P=1 in {partition_s:.2f} s (shard CSRs on the card {upload_s:.2f} s); "
              f"interior {interior.num_edges} edges (capacity {interior.capacity}), frontier "
              f"{frontier.num_edges} edges over a halo of {dg.halo_total} rows")
        check(interior.num_edges == e and frontier.num_edges == 0, "P = 1 must keep every edge interior")
        rng = np.random.default_rng(args.seed)
        norm = torch.from_numpy((rng.random((n, 1)) + 0.5).astype(np.float32)).to(dev)
        params = dist_params(DIST_DIMS, rng, dev)
        x, y, nn_ = (shard_node_array(mesh, a, dg) for a in (feats, labels, norm))

        # the single-device port's step on the global CSR, same widths,
        # weights and f32 stream (K1 with stream None on f32 features)
        with torch.no_grad():
            h = feats
            for i in range(len(DIST_DIMS) - 1):
                h = (h @ params[f"w{i}"] + params[f"b{i}"]) * norm
                h = _RowmaskSpmm.apply(h, None, csr, None, 1) * norm
                if i < len(DIST_DIMS) - 2:
                    h = torch.relu(h)
            single_loss = torch.nn.functional.cross_entropy(h, labels).item()
            del h

        opt = torch.optim.Adam(params.values(), lr=DIST_LR)

        def step():
            opt.zero_grad(set_to_none=True)
            loss, _ = dist_gcn_loss(mesh, dg, x, y, nn_, params, "kernel")
            loss.backward()
            reduce_replicated_grads(mesh, params)
            opt.step()
            torch.cuda.synchronize()
            return loss.item()

        t = time.perf_counter()
        warm_loss = step()
        warm_s = time.perf_counter() - t
        rel = abs(warm_loss - single_loss) / abs(single_loss)
        ok = rel <= DIST_LOSS_TOL
        print(f"dist-loss-check: world-size-1 loss {warm_loss:.7f}, single-device step on the global CSR "
              f"{single_loss:.7f}, relative difference {rel:.2e} (tol {DIST_LOSS_TOL:g}) {'ok' if ok else 'FAIL'}")
        check(ok, "the distributed loss at world size 1 differs from the single-device step")
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        reset_counts()
        halo_exchange.rows = halo_exchange.bytes = 0
        for _ in range(TRAIN_STEPS):
            t = time.perf_counter()
            losses.append(step())
            times.append(time.perf_counter() - t)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        print(f"dist-train: warm step {warm_s:.3f} s (loss {warm_loss:.4f}); {TRAIN_STEPS} Adam steps, s per step "
              f"{[round(v, 4) for v in times]}, losses {[round(v, 4) for v in losses]}, launches {counts}, peak "
              f"{peak / 2**30:.2f} GiB, halo rows sent {halo_exchange.rows}")
        check(counts == only(K1_traced=3 * TRAIN_STEPS, K1=3 * TRAIN_STEPS),
              f"the distributed step launched {counts}, expected 3 K1_traced + 3 K1 a step")
        # train.py's model sums unnormalised (norm in [0.5, 1.5], no degree
        # scaling), so at ogbn-products' ~10^6-edge hubs its logits reach
        # ~10^10 and Adam(1e-2) makes the loss oscillate rather than fall
        # (scale 0.1 on the card: 3.4e10, 1.9e10, 3.9e10, ...): the check is
        # that every step is finite and moves the parameters.
        check(all(np.isfinite([warm_loss] + losses)), f"non-finite distributed loss: {losses}")
        check(len(set([warm_loss] + losses)) > 1, f"the distributed steps did not move the loss: {losses}")
        total = torch.tensor([losses[-1]], device=dev)
        torch.distributed.all_reduce(total)  # one NCCL collective at world size 1
        check(abs(total.item() - losses[-1]) <= 1e-6 * abs(losses[-1]), "an all_reduce over one rank changed it")
        profile = phase_profile(step, "one distributed GCN training step")
        per_launch = {"K1_traced": [], "K1": []}
        for f in DIST_DIMS[1:]:
            per_launch["K1_traced"].append(dist_kernel_timings(interior, f, dev, traced=True))
            per_launch["K1"].append(dist_kernel_timings(interior.transpose(), f, dev, traced=False))
        del opt, params, x, y, nn_, shard, dg
    torch.cuda.empty_cache()
    return {"n": n, "e": e, "partition_s": partition_s, "upload_s": upload_s, "warm_s": warm_s,
            "warm_loss": warm_loss, "single_device_loss": single_loss, "loss_rel_diff": rel, "step_s": times,
            "losses": losses, "launches": counts, "peak_bytes": peak, "profile": profile, "per_launch": per_launch}


@timed_phase
def phase_dist_vs_plain(dev, args, workdir):
    """The distributed GCN at ``--scale 0.01`` (world size 1, NCCL): logits
    and every parameter's gradient on the kernel route (f32) against the
    plain route run in f64 on the same inputs and weights, each tensor to
    ``DIST_TOL`` of its largest element. (The plain route in f32 is no
    yardstick here: it sums a row in one f32 sequence, so over the hub rows
    ``train.py``'s unnormalised sums make its own error larger than the
    kernel's, whose 1024-edge chunks meet by atomics.)"""
    from stgraph_tpu_torch.dataset import OgbNodeDataLoader
    from stgraph_tpu_torch.parallel import make_mesh, partition_edges, shard_node_array

    data = OgbNodeDataLoader(root=workdir, scale=0.01, seed=args.seed)
    n = data.gdata["num_nodes"]
    edges = data.get_edges()
    feats = torch.from_numpy(data.get_all_features()).to(dev)
    labels = torch.from_numpy(data.get_all_targets()).to(dev)
    rng = np.random.default_rng(args.seed)
    norm = torch.from_numpy((rng.random((n, 1)) + 0.5).astype(np.float32)).to(dev)
    with world_of_one("nccl"):
        mesh = make_mesh()
        dg = partition_edges(edges[:, 0], edges[:, 1], n, 1)
        x, y, nn_ = (shard_node_array(mesh, a, dg) for a in (feats, labels, norm))
        res = {}
        for impl, dt in (("kernel", torch.float32), ("torch", torch.float64)):
            params = {k: v.detach().to(dt).requires_grad_()
                      for k, v in dist_params(DIST_DIMS, np.random.default_rng(args.seed + 1), dev).items()}
            loss, logits = dist_gcn_loss(mesh, dg, x.to(dt), y, nn_.to(dt), params, impl)
            loss.backward()
            res[impl] = {"logits": logits.detach(), **{k: p.grad for k, p in params.items()}}
    worst = {}
    for key, ref in res["torch"].items():
        worst[key] = ((res["kernel"][key].double() - ref).abs().max() / ref.abs().max().clamp(min=1e-300)).item()
    ok = max(worst.values()) <= DIST_TOL
    print(f"dist-check scale 0.01 (N={n}, E={len(edges)}): kernel route (f32) vs plain route (f64), err / max per "
          f"tensor { {k: f'{v:.2e}' for k, v in worst.items()} } (tol {DIST_TOL:g}) {'ok' if ok else 'FAIL'}")
    check(ok, "the distributed GCN's kernel route disagrees with its plain route at scale 0.01")
    return {"n": n, "e": len(edges), "err_over_max": worst}


def flat_store(rows0, cols0, nodes, capacity):
    """The (row, col)-sorted initial edges as a flat ``EdgeStore`` of
    ``capacity`` slots."""
    from stgraph_tpu_torch.graph.delta_graph import EdgeStore

    rows, cols = np.full(capacity, nodes, np.int32), np.full(capacity, nodes, np.int32)
    rows[:len(rows0)], cols[:len(cols0)] = rows0, cols0
    return EdgeStore(rows, cols, np.int32(len(rows0)), nodes)


def dist_dyn_small(seed):
    """The rank phase's dynamic graph (``DIST_DYN_SMALL``): the store, the
    stream, the features and the cotangent, the same in every process."""
    c = DIST_DYN_SMALL
    rng = np.random.default_rng(seed + 19)
    rows0, cols0, adds, dels, _ = dyn_stream(rng, c["nodes"], c["edges"], c["steps"], c["slide"])
    store = flat_store(rows0, cols0, c["nodes"], c["edges"] + 4 * c["slide"])
    feats = rng.standard_normal((c["nodes"], c["feat"]), dtype=np.float32)
    cot = rng.standard_normal((c["nodes"], c["feat"]), dtype=np.float32)
    return store, adds, dels, feats, cot


def dist_dyn_run(mesh, store, adds, dels, feats, cot, capacity=None, warm=False):
    """``parallel.dyn``'s replay on this rank's shard: per step the delta,
    ``dist_dyn_spmm`` forward and backward (cotangent ``cot``), then
    ``dist_dyn_degree``. Returns the last step's output and degrees, the
    features' gradient summed over the steps, the final store, the launches
    (counts set to 0 just before, read just after) and the step time; with
    ``warm``, the loop runs once untimed first."""
    from stgraph_tpu_torch.parallel import (
        dist_dyn_apply_delta,
        dist_dyn_degree,
        dist_dyn_spmm,
        partition_dynamic,
        shard_dyn_arrays,
        shard_node_array,
    )

    world = torch.distributed.get_world_size(mesh.get_group("graph"))
    t = time.perf_counter()
    ddg = partition_dynamic(store, adds, dels, None, world, capacity=capacity)
    partition_s = time.perf_counter() - t
    carry0, (a, d, _) = shard_dyn_arrays(mesh, ddg)
    g = shard_node_array(mesh, torch.from_numpy(cot), ddg)
    x = shard_node_array(mesh, torch.from_numpy(feats), ddg)

    def loop():
        rows, cols, w, ne = carry0
        h = x.clone().requires_grad_(True)
        for s in range(a.shape[0]):
            rows, cols, w, ne = dist_dyn_apply_delta(mesh, ddg, rows, cols, w, ne, a[s], d[s], None)
            out = dist_dyn_spmm(mesh, ddg, rows, cols, w, h)
            out.backward(g)
            deg = dist_dyn_degree(mesh, ddg, rows)
        return rows, cols, ne, out.detach(), deg, h.grad

    if warm:
        loop()
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    rows, cols, ne, out, deg, grad = loop()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / a.shape[0]
    counts = read_counts()

    def replay():
        rows_, cols_, w_, ne_ = carry0
        for s in range(a.shape[0]):
            rows_, cols_, w_, ne_ = dist_dyn_apply_delta(mesh, ddg, rows_, cols_, w_, ne_, a[s], d[s], None)
        torch.cuda.synchronize()

    replay()
    t = time.perf_counter()
    replay()
    update_s = (time.perf_counter() - t) / a.shape[0]
    return {"ddg": ddg, "x": x, "g": g, "rows": rows, "cols": cols, "ne": int(ne), "out": out, "deg": deg,
            "grad": grad, "counts": counts, "step_s": step_s, "update_s": update_s, "partition_s": partition_s}


@timed_phase
def phase_dist_dyn(dev, args, stream=None):
    """``parallel.dyn`` at ``bench.py``'s ``bench_dyn`` dyn-step shape (1.1M
    nodes, 2.2M slots, F = 128, 64 steps of 10k adds and 10k deletes: the
    dyn-step phase's ``stream``, or the same made anew), world size 1 on
    NCCL: a warm pass, then each step a replay
    (``dist_dyn_apply_delta``), ``dist_dyn_spmm`` forward and backward and
    ``dist_dyn_degree``; exactly one K6 and one K7 a step. After the 64 steps
    the store's live set is the generator's, the last output is within
    ``KERNEL_TOL`` of the sum of |terms| of K6's plain version over the whole
    store, and one more call's gradient within it of the plain transpose."""
    from stgraph_tpu_torch.ops.rowid_kernels import spmm_rowid_plain
    from stgraph_tpu_torch.parallel import dist_dyn_spmm, make_mesh

    rng = np.random.default_rng(args.seed + 17)
    nodes, cap, steps, f = DYN_NODES, DYN_CAP, DYN_STEPS, DYN_F
    e0 = cap - DYN_TCAP - 40_000
    t = time.perf_counter()
    if stream is None:
        rows0, cols0, adds, dels, live = dyn_stream(np.random.default_rng(args.seed), nodes, e0, steps, DYN_SLIDE)
        want = np.array(sorted(live), np.int64)
    else:
        rows0, cols0, adds, dels, want = stream
    store = flat_store(rows0, cols0, nodes, cap)
    feats = rng.standard_normal((nodes, f), dtype=np.float32)
    cot = rng.standard_normal((nodes, f), dtype=np.float32)
    stream_s = time.perf_counter() - t
    with world_of_one("nccl"):
        mesh = make_mesh()
        r = dist_dyn_run(mesh, store, adds, dels, feats, cot, capacity=cap, warm=True)
        check(r["counts"] == only(K6=steps, K7=steps), f"the dist-dyn run launched {r['counts']}, expected one K6 "
              "and one K7 a step")
        rows, cols = r["rows"], r["cols"]
        live_rows = rows < nodes
        got = np.sort(cols[live_rows].cpu().numpy().astype(np.int64) * nodes + rows[live_rows].cpu().numpy())
        check(np.array_equal(got, want) and r["ne"] == len(want),
              f"the dist-dyn store's live set differs from the generator's ({len(got)} vs {len(want)} edges)")
        with torch.no_grad():
            ref = spmm_rowid_plain(rows, cols, None, r["x"], nodes, ROWID_PLAIN_EDGE_BLOCK)
            mass = spmm_rowid_plain(rows, cols, None, r["x"].abs(), nodes, ROWID_PLAIN_EDGE_BLOCK)
            out_err = (r["out"] - ref).abs()
            out_ratio = _err_over_mass(out_err, mass)
            del ref, mass
        h = r["x"].clone().requires_grad_(True)
        dist_dyn_spmm(mesh, r["ddg"], rows, cols, None, h).backward(r["g"])
        with torch.no_grad():
            ref = spmm_rowid_plain(cols, rows, None, r["g"], nodes, ROWID_PLAIN_EDGE_BLOCK)  # the transpose
            mass = spmm_rowid_plain(cols, rows, None, r["g"].abs(), nodes, ROWID_PLAIN_EDGE_BLOCK)
            grad_ratio = _err_over_mass((h.grad - ref).abs(), mass)
            del ref, mass
        check(out_ratio <= KERNEL_TOL and grad_ratio <= KERNEL_TOL,
              f"dist-dyn: output err/sum|terms| {out_ratio}, gradient {grad_ratio} (tol {KERNEL_TOL})")
        deg_ok = bool(torch.equal(r["deg"][:, 0], torch.bincount(rows[live_rows].long(), minlength=nodes).float()))
        check(deg_ok, "dist-dyn: dist_dyn_degree differs from the store's in-degrees")
    print(f"dist-dyn: {e0} initial edges on {nodes} nodes, capacity {cap}, {steps} steps of {DYN_SLIDE} adds + "
          f"{DYN_SLIDE} deletes, F={f}, world size 1 (NCCL); stream {stream_s:.2f} s, partition "
          f"{r['partition_s']:.2f} s; a step (replay, dist_dyn_spmm forward and backward, degree) "
          f"{r['step_s'] * 1e3:.3f} ms, the replay alone {r['update_s'] * 1e3:.3f} ms; launches {r['counts']}; "
          f"live set equal ({len(want)} edges); output err/sum|terms| {out_ratio:.2e}, gradient {grad_ratio:.2e}, "
          f"degrees exact")
    return {"nodes": nodes, "capacity": cap, "initial_edges": int(e0), "steps": steps, "slide": DYN_SLIDE, "F": f,
            "stream_s": stream_s, "partition_s": r["partition_s"], "step_s": r["step_s"], "update_s": r["update_s"],
            "launches": r["counts"], "live_edges": len(want), "out_max_abs_err": out_err.max().item(),
            "out_err_over_mass": out_ratio, "grad_err_over_mass": grad_ratio}


def batched_tgcn_data(workdir):
    """``parallel.batch``'s windows on WindmillOutput large: (B, T, N, F)
    features, each timestep's ``STATIC_F`` past targets (the static-temporal
    script's features), and (B, T, N, H) targets, the next target in every
    column; the graph's (src, dst) and its ``deg^-1/2`` norm (in-degrees)."""
    from stgraph_tpu_torch.dataset import STGraphDataset
    from stgraph_tpu_torch.drivers.static_temporal_tgcn import load_dataset

    STGraphDataset._offline = True  # no network here: the synthetic data
    b_n, t_n, f = BATCH_WINDOWS, BATCH_STEPS, STATIC_F
    d = load_dataset("windmill_large", f, f + b_n * t_n + 1, os.path.join(workdir, "datasets"))
    targets = np.stack(d.get_all_targets()).astype(np.float32)
    edges = np.asarray(d.get_edges(), np.int64)
    n = targets.shape[1]
    xs = np.stack([[targets[b * t_n + t:b * t_n + t + f].T for t in range(t_n)] for b in range(b_n)])
    ys = np.stack([[np.repeat(targets[b * t_n + t + f][:, None], STATIC_H, 1) for t in range(t_n)]
                   for b in range(b_n)])
    deg = np.bincount(edges[:, 1], minlength=n).astype(np.float32)
    norm = np.where(deg > 0, np.maximum(deg, 1) ** -0.5, 1.0).astype(np.float32)[:, None]
    return {"src": edges[:, 0], "dst": edges[:, 1], "n": n, "xs": np.ascontiguousarray(xs, np.float32),
            "ys": np.ascontiguousarray(ys, np.float32), "norm": norm}


def batched_tgcn_run(mesh, data, seed, sequential=False):
    """``dist_tgcn_batched_loss`` (or, with ``sequential``, the same windows
    one by one through ``dist_tgcn_cell`` from zero hidden states, the masked
    MSE over the real rows, ``reduce_replicated_grads`` after the backward)
    on this rank's mesh, K1's shard mode; TGCN(STATIC_F -> STATIC_H) drawn
    from ``seed``. Returns the loss, the gradients, the launches (counts set
    to 0 just before, read just after), the launches expected (3 K1_traced
    and 3 K1 a cell and non-empty split of the shard) and the seconds of the
    forward and backward (the sequential run's include an upload of each
    timestep's rows)."""
    from stgraph_tpu_torch.parallel import (
        dist_tgcn_batched_loss,
        dist_tgcn_cell,
        dist_tgcn_params,
        partition_edges,
        reduce_replicated_grads,
        shard_node_array,
        shard_window_batch,
    )
    from stgraph_tpu_torch.parallel.layers import _leaves
    from stgraph_tpu_torch.parallel.mesh import mesh_device, staged_collective

    dev = mesh_device(mesh)
    graph = torch.distributed.get_world_size(mesh.get_group("graph"))
    dg = partition_edges(data["src"], data["dst"], data["n"], graph)
    params = dist_tgcn_params(torch.Generator().manual_seed(seed), STATIC_F, STATIC_H, device=dev)
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    norm = shard_node_array(mesh, torch.from_numpy(data["norm"]), dg)
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    if sequential:
        ns, n = dg.nodes_per_shard, data["n"]
        r = mesh.get_local_rank("graph")
        mask = (r * ns + torch.arange(ns, device=dev) < n)[:, None]
        total = 0.0
        for b in range(data["xs"].shape[0]):
            hidden, steps = torch.zeros(ns, STATIC_H, device=dev), []
            for s in range(data["xs"].shape[1]):
                x = shard_node_array(mesh, torch.from_numpy(data["xs"][b, s]), dg)
                y = shard_node_array(mesh, torch.from_numpy(data["ys"][b, s]), dg)
                hidden = dist_tgcn_cell(mesh, dg, params, x, norm, hidden, impl="kernel")
                steps.append(torch.where(mask, (hidden - y) ** 2, 0.0).sum() / (n * STATIC_H))
            total = total + torch.stack(steps).mean()
        loss = total / data["xs"].shape[0]
        loss.backward()
        reduce_replicated_grads(mesh, params)
        loss = staged_collective(torch.distributed.all_reduce, loss.detach().clone(), mesh.get_group("graph"))
    else:
        xs = shard_window_batch(mesh, data["xs"], dg)
        ys = shard_window_batch(mesh, data["ys"], dg)
        loss = dist_tgcn_batched_loss(mesh, dg, params, norm, xs, ys)
        loss.backward()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = read_counts()
    shard = dg.shard(mesh.get_local_rank("graph"), dev)
    cells = (data["xs"].shape[0] if sequential else xs.shape[0]) * data["xs"].shape[1]
    splits = (shard.interior_csr.num_edges > 0) + (shard.frontier_csr.num_edges > 0)
    grads = {"/".join(k): v.grad.detach().cpu().numpy() for k, v in _named_leaves(params)}
    return {"loss": loss.item(), "grads": grads, "counts": counts, "seconds": seconds,
            "expected": only(K1_traced=3 * splits * cells, K1=3 * splits * cells)}


def _named_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _grads_err(got, ref):
    """Each gradient's largest error over its largest element."""
    return {k: float(np.abs(got[k] - v).max() / max(np.abs(v).max(), 1e-30)) for k, v in ref.items()}


@timed_phase
def phase_batched_tgcn(dev, args, workdir):
    """``parallel.batch`` on a 1 x 1 mesh (NCCL): ``dist_tgcn_batched_loss``
    over ``BATCH_WINDOWS`` windows of ``BATCH_STEPS`` timesteps of
    WindmillOutput large at ``STATIC_F -> STATIC_H``, K1's shard mode
    (exactly 3 K1_traced and 3 K1 a timestep of a window), its loss and
    gradients against the same windows run one by one through
    ``dist_tgcn_cell`` to ``DIST_TOL``."""
    from stgraph_tpu_torch.parallel import make_mesh

    data = batched_tgcn_data(workdir)
    with world_of_one("nccl"):
        mesh = make_mesh()
        batched_tgcn_run(mesh, data, args.seed)  # warm
        run = batched_tgcn_run(mesh, data, args.seed)
        ref = batched_tgcn_run(mesh, data, args.seed, sequential=True)
    loss, counts, seconds, ref_loss, ref_seconds = run["loss"], run["counts"], run["seconds"], ref["loss"], \
        ref["seconds"]
    check(counts == run["expected"] == only(K1_traced=3 * BATCH_WINDOWS * BATCH_STEPS,
                                           K1=3 * BATCH_WINDOWS * BATCH_STEPS),
          f"the batched TGCN launched {counts}, expected 3 K1_traced and 3 K1 a timestep")
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    grad_err = _grads_err(run["grads"], ref["grads"])
    print(f"batched-tgcn: WindmillOutput large N={data['n']}, E={len(data['src'])}, {BATCH_WINDOWS} windows of "
          f"{BATCH_STEPS} timesteps, F={STATIC_F} H={STATIC_H}, 1 x 1 mesh (NCCL): loss {loss:.6f} against the "
          f"sequential windows' {ref_loss:.6f} (relative {loss_err:.2e}), gradients err/max worst "
          f"{max(grad_err.values()):.2e} (tol {DIST_TOL:g}); forward and backward {seconds:.3f} s (sequential "
          f"{ref_seconds:.3f} s); launches {counts}")
    check(loss_err <= DIST_TOL and max(grad_err.values()) <= DIST_TOL,
          f"the batched TGCN loss or gradients differ from the sequential windows': {loss_err}, {grad_err}")
    return {"n": data["n"], "e": len(data["src"]), "windows": BATCH_WINDOWS, "timesteps": BATCH_STEPS,
            "F": STATIC_F, "H": STATIC_H, "loss": loss, "loss_sequential": ref_loss, "loss_rel_diff": loss_err,
            "grad_err_over_max": grad_err, "seconds": seconds, "sequential_seconds": ref_seconds,
            "launches": counts}


def evolvegcn_records(tr, steps):
    """The first ``steps`` timesteps of ``tr``'s epoch (an
    ``EvolveGCNTrainer``), forward and backward from the ``weight``
    parameter: (loss, the evolved weight, the gradients by name)."""
    loss, w = tr.backward(steps)
    grads = {k: p.grad.clone() for k, p in (*tr.conv.named_parameters(), *(
        (f"head.{k}", p) for k, p in tr.head.named_parameters()))}
    torch.cuda.synchronize()
    return loss.item(), w, grads


@timed_phase
def phase_evolvegcn(dev, args, workdir):
    """``benchmarking/evolvegcn/train.py --variant o|h --dataset wikimath
    --feat_size 8 --num_hidden 32 --impl kernel`` on the port
    (``drivers.evolvegcn``): for each variant, first the kernel route
    against the dense route over the first ``TEMPORAL_PROFILE_STEPS``
    timesteps from the same seed's parameters (loss and evolved weight to
    ``STATIC_LOSS_TOL``, gradients to ``STATIC_GRAD_TOL``), then the
    script's ``EVOLVE_EPOCHS`` epochs, timed (the script averages epochs
    >= 3), each launching exactly T K1 and T K2 (the weighted SpMM of the
    GCN aggregate, f32 streams) and nothing else, the loss finite and below
    the first epoch's at a later one; a profile of the first
    ``TEMPORAL_PROFILE_STEPS`` timesteps; then K1 and K2 with the arguments
    a timestep gives them against their plain versions, timed
    (``k1_k2_at_temporal_shape``)."""
    from stgraph_tpu_torch.dataset import STGraphDataset
    from stgraph_tpu_torch.drivers.evolvegcn import EvolveGCNTrainer, load_evolvegcn_dataset

    STGraphDataset._offline = True  # no network here: the synthetic data
    t0 = time.perf_counter()
    d = load_evolvegcn_dataset("wikimath", EVOLVE_F, None, os.path.join(workdir, "datasets"))
    load_s = time.perf_counter() - t0

    def trainer(variant, impl):
        return EvolveGCNTrainer(d, variant, EVOLVE_F, EVOLVE_H, EVOLVE_LR, impl, dev, args.seed)

    runs, per, last_loss = {}, None, None
    for variant in ("o", "h"):
        name = f"EvolveGCN-{variant.upper()}"
        # the first timesteps on the kernel route against the dense route,
        # from the same seed's parameters, before any training
        route = {}
        for impl in ("kernel", "dense"):
            reset_counts()
            route[impl] = evolvegcn_records(trainer(variant, impl), TEMPORAL_PROFILE_STEPS)
            route[impl + "_launches"] = read_counts()
        (k_loss, k_w, k_grads), (d_loss, d_w, d_grads) = route["kernel"], route["dense"]
        loss_err = abs(k_loss - d_loss) / max(abs(d_loss), 1e-30)
        w_err = (k_w - d_w).abs().max().item() / max(d_w.abs().max().item(), 1e-30)
        grad_err = {k: (k_grads[k] - v).abs().max().item() / max(v.abs().max().item(), 1e-30)
                    for k, v in d_grads.items()}
        ok = (loss_err <= STATIC_LOSS_TOL and w_err <= STATIC_LOSS_TOL and max(grad_err.values()) <= STATIC_GRAD_TOL
              and route["dense_launches"] == only()
              and route["kernel_launches"] == only(K1=TEMPORAL_PROFILE_STEPS, K2=TEMPORAL_PROFILE_STEPS))
        print(f"evolvegcn-check {variant}: the first {TEMPORAL_PROFILE_STEPS} timesteps, kernel route vs dense: "
              f"loss {k_loss:.6f} / {d_loss:.6f} (err/|loss| {loss_err:.2e}), evolved weight err/max {w_err:.2e} "
              f"(tol {STATIC_LOSS_TOL:g}), worst gradient err/max {max(grad_err.values()):.2e} (tol "
              f"{STATIC_GRAD_TOL:g}); launches {route['kernel_launches']} / {route['dense_launches']} "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name}'s kernel route disagrees with its dense route: loss {loss_err}, weight {w_err}, "
                  f"gradients {grad_err}, launches {route['kernel_launches']} / {route['dense_launches']}")
        t = time.perf_counter()
        tr = trainer(variant, "kernel")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        # what the run starts from, for tools/evolvegcn_trajectory.py's --init
        init = {f"{m}.{k}": v.cpu().numpy().tolist() for m, mod in (("conv", tr.conv), ("head", tr.head))
                for k, v in mod.state_dict().items()}
        n, e, steps = tr.num_nodes, tr.graph.fwd_csr.num_edges, tr.total
        expected = only(K1=steps, K2=steps)
        reset_counts()
        losses, times, per_epoch = [], [], []
        for _ in range(EVOLVE_EPOCHS):
            before = read_counts()
            t = time.perf_counter()
            last_loss = tr.epoch()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            losses.append(last_loss.item())
            per_epoch.append({k: v - before[k] for k, v in read_counts().items()})
        counts = read_counts()
        avg_s = float(np.mean(times[3:]))  # the script's average: epochs >= 3
        profile = phase_profile(lambda: tr.backward(TEMPORAL_PROFILE_STEPS), f"the first {TEMPORAL_PROFILE_STEPS} "
                                f"timesteps of an {name} epoch")
        print(f"evolvegcn {variant}: WikiMath N={n}, E={e}, T={steps} timesteps, F={EVOLVE_F} H={EVOLVE_H}, kernel "
              f"route (data {load_s:.2f} s, set-up {setup_s:.2f} s); {EVOLVE_EPOCHS} epochs, s "
              f"{[round(v, 3) for v in times]} (avg >= 3: {avg_s:.4f} s), loss {[round(v, 5) for v in losses]}; "
              f"launches an epoch {per_epoch[0]}; idle share {profile['idle_share']:.3f}")
        check(all(c == expected for c in per_epoch), f"an {name} epoch launched {per_epoch}, expected {expected}")
        check(all(np.isfinite(losses)), f"non-finite {name} loss: {losses}")
        # one Adam step an epoch through 723 timesteps of BPTT: the loss
        # swings from epoch to epoch at the script's lr, so what is checked
        # is that training takes it below the first epoch's
        check(min(losses[1:]) < losses[0], f"the {name} loss never fell below the first epoch's: {losses}")
        if per is None:  # K1 and K2 take the same arguments' shapes in both variants
            per = k1_k2_at_temporal_shape("evolvegcn", lambda: tr.backward(1), None)
        runs[variant] = {"n": n, "e": e, "timesteps": steps, "F": EVOLVE_F, "H": EVOLVE_H, "route": "kernel",
                         "load_s": load_s, "setup_s": setup_s, "epoch_s": times, "avg_epoch_s": avg_s,
                         "loss": losses, "launches": counts, "launches_per_epoch": per_epoch,
                         "profile": profile, "profile_timesteps": TEMPORAL_PROFILE_STEPS, "init": init,
                         "data": {"targets_f64_sum": float(tr.ys.double().sum()),
                                  "targets_f64_abs_sum": float(tr.ys.double().abs().sum()),
                                  "csr_rows_sum": int(tr.graph.fwd_csr.rows.long().sum()),
                                  "csr_cols_sum": int(tr.graph.fwd_csr.cols.long().sum())},
                         "kernel_vs_dense": {"timesteps": TEMPORAL_PROFILE_STEPS, "loss": [k_loss, d_loss],
                                             "loss_err": loss_err, "weight_err": w_err, "grad_err": grad_err}}
    return {"runs": runs, "per_launch": per, "loss": last_loss}


def segment_sum_edges_bound(n: int, e: int, k: int, elem_bytes: int):
    """Least time for one ``segment_sum_edges`` call: indptr and the (E, K)
    plane of the values' dtype read once, the (N, K) f32 output written
    once; or one add per edge and column."""
    nbytes = (n + 1) * 4 + e * k * elem_bytes + n * k * 4
    ops = e * k
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


@timed_phase
def phase_segment_sum_edges(dev, rng, n=100_000, e=1_000_000, hub_deg=150_000):
    """``ops.segment_sum_edges`` on the composed check graph (``check_graph``:
    a hub each way, empty rows and row blocks, padding slots) at K in
    ``SEGMENT_SUM_EDGES_K``, f32 and bf16 values with NaN in every padding
    slot: one launch of K3 (K <= 16) or of K1's no-gather mode a call (bf16
    values also take one PyTorch cast to an f32 plane first), into a
    poisoned output, within ``KERNEL_TOL`` of each output's sum of |terms|
    of its plain version (the no-gather sum's bf16 stream only for bf16
    values), an f32 result; the backward equal to the gather
    ``g[rows_clamped] * edge_mask`` and launching nothing; then each call
    timed (the bf16 cast included) beside its plain version,
    ``torch.segment_reduce`` and its bound."""
    from stgraph_tpu_torch.ops import segment_kernels as SK
    from stgraph_tpu_torch.ops import segment_sum_edges

    csr, _ = check_graph(dev, rng, n, e, hub_deg)
    e_real = csr.num_edges
    rows_c, mask = csr.rows_clamped.long(), csr.edge_mask[:, None].float()
    per, worst = [], {"K3": 0.0, "K1_nogather": 0.0}
    for k in SEGMENT_SUM_EDGES_K:
        key = "K3" if k <= SK.MAX_NARROW_K else "K1_nogather"
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            vals = torch.from_numpy(rng.standard_normal((csr.capacity, k), dtype=np.float32)).to(dev).to(dtype)
            vals[e_real:] = float("nan")
            if key == "K3":
                def plain(v):
                    return SK.segment_sum_narrow_plain(csr, v, 1 << 24)
            else:
                def plain(v, bf16=dtype == torch.bfloat16):
                    return SK.segment_sum_wide_plain(csr, v, 1 << 24, round_bf16=bf16)

            def call(vals=vals):
                return segment_sum_edges(csr, vals)

            call()  # the plan, built once
            reset_counts()
            out = poisoned_call((n, k), call)
            torch.cuda.synchronize()
            counts = read_counts()
            check(counts == only(**{key: 1}), f"segment_sum_edges K={k} {name} launched {counts}, expected one {key}")
            check(out.dtype == torch.float32, f"segment_sum_edges K={k} {name} returned {out.dtype}")
            (a, r, _), = _stats([out], [plain(vals)], [plain(vals.abs())])
            del out
            v = vals.clone().requires_grad_()
            g = torch.from_numpy(rng.standard_normal((n, k), dtype=np.float32)).to(dev)
            reset_counts()
            segment_sum_edges(csr, v).backward(g)
            torch.cuda.synchronize()
            bwd_ok = torch.equal(v.grad, (g[rows_c] * mask).to(dtype)) and read_counts() == only(**{key: 1})
            ok = r <= KERNEL_TOL and bwd_ok
            bound_ms, bound_by, nbytes, ops = segment_sum_edges_bound(n, e_real, k, vals.element_size())
            ms = cuda_ms(call, iters=20, warmup=2)
            cast = " (and the cast to f32 before it)" if dtype == torch.bfloat16 else ""
            plain_ms = cuda_ms(lambda: plain(vals), iters=3)
            lib_ms = _library_segment_sum_ms(csr, vals, e_real)
            print(f"segment-sum-edges K={k} {name} ({key}): N={n} E={e_real}, NaN padding: max_abs_err {a:.3e} "
                  f"(err/sum|terms| {r:.2e}, tol {KERNEL_TOL:g}), one kernel launch{cast}, f32 out, backward the gather "
                  f"{'ok' if bwd_ok else 'FAIL'}; {ms:.4f} ms (plain {plain_ms:.3f} ms, segment_reduce {lib_ms} ms, "
                  f"bound {bound_ms:.4f} ms by {bound_by}) {'ok' if ok else 'FAIL'}")
            check(ok, f"segment_sum_edges K={k} {name} disagrees: forward {r}, backward gather {bwd_ok}")
            worst[key] = max(worst[key], a)
            per.append({"where": f"segment_sum_edges K={k} {name}", "kernel": key, "K": k, "stream": name,
                        "N": n, "E": e_real, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        "library": "torch.segment_reduce(sum)", "bound_ms": bound_ms, "bound_by": bound_by,
                        "bytes": nbytes, "ops": ops, "max_abs_err": a, "err_over_mass": r,
                        "cast_to_f32_launch": dtype == torch.bfloat16})
            del vals, v, g
    return {"per_launch": per, "max_abs_err": worst}


@timed_phase
def phase_utilities(dev, workdir, loss):
    """The port's utilities on the card: ``DeviceInfo``'s rows,
    ``device_memory_stats`` against the allocator's own peak and the card's
    memory, a ``Timer`` around synced K1 calls (against CUDA events),
    ``profiler.trace`` of one K1 call in a fresh process (``trace_worker``)
    writing a trace under the workdir that holds K1's kernel once, the same
    trace in this process after ``profile_fill`` (recorded),
    ``fetch_float`` of EvolveGCN's last loss against ``.item()``;
    ``d2h_available()`` must still be true at the end."""
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops import spmm_kernels as SK
    from stgraph_tpu_torch.utils import DeviceInfo, d2h_available, fetch_float, profiler

    info = DeviceInfo()
    rows = info.rows()
    info.log()
    check(len(rows) == torch.cuda.device_count() and rows[0]["platform"] == "gpu"
          and rows[0]["kind"] == torch.cuda.get_device_name(0), f"DeviceInfo's rows {rows}")
    stats = profiler.device_memory_stats()
    peak, limit = torch.cuda.max_memory_allocated(0), torch.cuda.get_device_properties(0).total_memory
    check(stats["cuda:0"]["peak_bytes_in_use"] == peak and stats["cuda:0"]["bytes_limit"] == limit,
          f"device_memory_stats {stats} against the allocator's peak {peak} and the card's {limit} B")
    rng = np.random.default_rng(0)
    n, e, f = 100_000, 1_000_000, 64
    csr = build_csr(rng.integers(0, n, e), rng.integers(0, n, e), n, device=dev)
    x = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32)).to(dev)
    SK.spmm_rowmask(csr, None, x)  # the work items, built once
    timer, calls = profiler.Timer(), 5
    before = SK.spmm_rowmask.launches
    for _ in range(calls):
        with timer.time("k1") as sync:
            sync.value = SK.spmm_rowmask(csr, None, x)[0]
    check(SK.spmm_rowmask.launches - before == calls, "the timed K1 calls did not launch K1 once each")
    k1_ms = cuda_ms(lambda: SK.spmm_rowmask(csr, None, x), iters=20, warmup=2)
    # profiler.trace in a fresh process (trace_worker), where the profiler
    # keeps a window's first device events (PROFILE_FILLERS): one K1 call
    logdir = os.path.join(workdir, "trace")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-worker", logdir], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    worker_s = time.perf_counter() - t
    check(proc.returncode == 0, f"the trace worker failed ({proc.returncode}): {proc.stderr[-2000:]}")
    worker = json.loads(proc.stdout.strip().splitlines()[-1])
    trace = trace_kernels(logdir)
    check(worker["k1_launches"] == 1 and trace["k1_kernels"] == 1,
          f"profiler.trace of one K1 call in a fresh process: {worker['k1_launches']} launches, {trace}")
    # the same in this process, late in the run, after profile_fill: what
    # the fill recovers (recorded, not checked)
    late_dir = os.path.join(workdir, "trace_late")
    with profiler.trace(late_dir):
        profile_fill()
        SK.spmm_rowmask(csr, None, x)
        torch.cuda.synchronize()
    late = trace_kernels(late_dir)
    fetched, item = fetch_float(loss), loss.item()
    available = d2h_available()
    print(f"utilities: DeviceInfo {rows}; device_memory_stats peak {stats['cuda:0']['peak_bytes_in_use']} B = "
          f"max_memory_allocated, limit {limit} B; Timer over {calls} synced K1 calls (N={n}, E={e}, F={f}) "
          f"{timer.mean('k1') * 1e3:.4f} ms a call on the host clock (CUDA events {k1_ms:.4f} ms); trace of one "
          f"K1 call in a fresh process ({worker_s:.1f} s) {trace['file']}: {trace['events']} events "
          f"({trace['categories']}), {trace['kernels']} device kernels, {trace['k1_kernels']} of them K1's; the same "
          f"in this process after {PROFILE_FILLERS} fill kernels: {late['kernels']} device kernels, {late['k1_kernels']} "
          f"K1's; "
          f"fetch_float(EvolveGCN loss) {fetched!r} (.item() {item!r}); d2h_available {available}")
    check(fetched == item, f"fetch_float gave {fetched}, .item() {item}")
    check(available, "a device fetch timed out: d2h_available() latched false")
    return {"device_info": rows, "memory_stats": stats, "timer": timer.summary(), "k1_cuda_events_ms": k1_ms,
            "trace": trace, "trace_worker_s": worker_s, "trace_in_process_padded": late, "fetch_float": fetched,
            "d2h_available": available}


def trace_kernels(logdir) -> dict:
    """The one Chrome trace that ``profiler.trace`` wrote into ``logdir``:
    its events, their categories, its device kernels and K1's among them."""
    files = os.listdir(logdir)
    check(len(files) == 1, f"profiler.trace wrote {files}")
    with open(os.path.join(logdir, files[0])) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels = [str(ev.get("name")) for ev in events if str(ev.get("cat")).lower() == "kernel"]
    return {"file": files[0], "events": len(events), "categories": sorted({str(ev.get("cat")) for ev in events}),
            "kernels": len(kernels), "k1_kernels": sum(PROFILED_KERNELS["K1"] in k for k in kernels)}


def trace_worker(dev, logdir) -> None:
    """``phase_utilities``' fresh process: one K1 call (N = 100,000, E =
    1,000,000, F = 64, its work items built by a first call) inside
    ``utils.profiler.trace(logdir)``; prints its K1 launches as JSON."""
    from stgraph_tpu_torch.graph.csr import build_csr
    from stgraph_tpu_torch.ops import spmm_kernels as SK
    from stgraph_tpu_torch.utils import profiler

    rng = np.random.default_rng(0)
    n, e, f = 100_000, 1_000_000, 64
    csr = build_csr(rng.integers(0, n, e), rng.integers(0, n, e), n, device=dev)
    x = torch.from_numpy(rng.standard_normal((n, f), dtype=np.float32)).to(dev)
    SK.spmm_rowmask(csr, None, x)
    torch.cuda.synchronize()
    before = SK.spmm_rowmask.launches
    with profiler.trace(logdir):
        SK.spmm_rowmask(csr, None, x)
        torch.cuda.synchronize()
    print(json.dumps({"k1_launches": SK.spmm_rowmask.launches - before}))


def dist_worker(rank, world, port, out_path, seed, backend):
    """One of ``phase_dist_halo_2rank``'s ranks on ``backend`` (gloo on the
    one card, or NCCL on a card each), ``train.py``'s
    synthetic graph split in ``world``; the training step's loss and
    gradients (kernel route), ``dist_gat_attention`` at 4 x 32 on both
    routes, values and gradients, and what this rank launched and sent."""
    from stgraph_tpu_torch.parallel import (
        dist_gat_attention,
        launch,
        make_mesh,
        partition_edges,
        shard_node_array,
    )
    from stgraph_tpu_torch.parallel.halo import exchange
    from stgraph_tpu_torch.parallel.mesh import mesh_device

    launch.initialize(f"127.0.0.1:{port}", world, rank, backend=backend)
    try:
        mesh = make_mesh()
        dev = mesh_device(mesh)
        data = dist_train_data(seed, **DIST_SMALL)
        t = time.perf_counter()
        dg = partition_edges(data[0], data[1], DIST_SMALL["nodes"], world)
        partition_s = time.perf_counter() - t
        shard = dg.shard(rank, dev)
        params = dist_params(data[6], data[5], dev)
        batch = dist_batch(mesh, dg, data)
        reset_counts()
        exchange.rows = exchange.bytes = 0
        loss, grads = dist_step_grads(mesh, dg, batch, params, "kernel")
        torch.cuda.synchronize()
        step_counts = read_counts()
        step_rows, step_bytes = exchange.rows, exchange.bytes
        step_s = []
        for _ in range(3):  # the same step again, timed (the ranks in lockstep)
            t = time.perf_counter()
            dist_step_grads(mesh, dg, batch, params, "kernel")
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
        h, f = DIST_GAT_TILING
        grng = np.random.default_rng(seed + 3)
        nodes = DIST_SMALL["nodes"]
        arrays = [grng.standard_normal(s).astype(np.float32)
                  for s in ((nodes, h), (nodes, h), (nodes, h, f), (nodes, h, f))]
        el, er, fs, g = (shard_node_array(mesh, torch.from_numpy(a), dg) for a in arrays)
        gat = {}
        for impl in ("kernel", "torch"):
            a, b, c = (t_.clone().requires_grad_() for t_ in (el, er, fs))
            out = dist_gat_attention(mesh, dg, a, b, c, impl=impl)
            (out * g).sum().backward()
            gat[impl] = [out.detach(), a.grad, b.grad, c.grad]
        gat_err = [(k - p).abs().max().item() for k, p in zip(gat["kernel"], gat["torch"])]
        gat_max = [p.abs().max().item() for p in gat["torch"]]
        # parallel.dyn at DIST_DYN_SMALL, and parallel.batch on the
        # (world x 1) and (1 x world) meshes
        dyn = dist_dyn_run(mesh, *dist_dyn_small(seed), warm=True)
        extra = {"dyn_out": dyn["out"].cpu().numpy(), "dyn_deg": dyn["deg"].cpu().numpy(),
                 "dyn_grad": dyn["grad"].cpu().numpy(), "dyn_ne": dyn["ne"], "dyn_step_s": dyn["step_s"],
                 "dyn_update_s": dyn["update_s"], "dyn_counts": json.dumps(dyn["counts"])}
        bdata = batched_tgcn_data(os.path.dirname(out_path))
        for data_n, graph_n in ((world, 1), (1, world)):
            run = batched_tgcn_run(make_mesh(graph=graph_n, data=data_n), bdata, seed)
            m = f"batch_{data_n}x{graph_n}"
            extra.update({f"{m}_loss": run["loss"], f"{m}_s": run["seconds"], f"{m}_counts": json.dumps(run["counts"]),
                          f"{m}_expected": json.dumps(run["expected"]),
                          **{f"{m}_grad_{k}": v for k, v in run["grads"].items()}})
        np.savez(out_path, loss=loss, partition_s=partition_s, step_s=step_s, gat_err=gat_err, gat_max=gat_max,
                 interior_edges=shard.interior_csr.num_edges, frontier_edges=shard.frontier_csr.num_edges,
                 halo_total=dg.halo_total, rows_sent=step_rows, bytes_sent=step_bytes,
                 counts=json.dumps(step_counts), **{f"grad_{k}": v.cpu().numpy() for k, v in grads.items()}, **extra)
    finally:
        launch.shutdown()


@timed_phase
def phase_dist_halo_2rank(dev, args, workdir, n_ranks=DIST_RANKS):
    """dist-halo-2rank: ``n_ranks`` processes, NCCL on a card each where
    there are as many cards, else gloo on the one card, on
    ``benchmarking/dist/train.py``'s default synthetic graph: the training
    step's loss and gradients against the same step at world size 1 (f32,
    only the order of sums differs), the GAT attention's kernel route
    against its plain route at 4 x 32, and each rank's launches, halo
    traffic and step time. A failure in any rank fails the phase."""
    import socket

    from stgraph_tpu_torch.parallel import make_mesh, partition_edges

    backend = "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    data = dist_train_data(args.seed, **DIST_SMALL)
    bdata = batched_tgcn_data(workdir)  # the ranks load the same cache
    with world_of_one("nccl"):
        mesh = make_mesh()
        dg1 = partition_edges(data[0], data[1], DIST_SMALL["nodes"], 1)
        ref_loss, ref_grads = dist_step_grads(mesh, dg1, dist_batch(mesh, dg1, data), dist_params(data[6], data[5], dev),
                                              "kernel")
        del dg1
        dyn_ref = dist_dyn_run(mesh, *dist_dyn_small(args.seed), warm=True)
        dyn_ref = {k: dyn_ref[k].cpu().numpy() if torch.is_tensor(dyn_ref[k]) else dyn_ref[k]
                   for k in ("out", "deg", "grad", "ne", "step_s")}
        batch_ref = batched_tgcn_run(mesh, bdata, args.seed, sequential=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t = time.perf_counter()
    outs = [os.path.join(workdir, f"dist_rank{r}.npz") for r in range(n_ranks)]
    # the ranks share the host's cores: torch's default threads in each
    # would oversubscribe them
    env = dict(os.environ, OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // n_ranks)))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seed", str(args.seed), "--dist-worker",
                               f"{r},{n_ranks},{port},{outs[r]},{backend}"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env) for r in range(n_ranks)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=DIST_WORKER_TIMEOUT)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall_s = time.perf_counter() - t
    for r, (proc, log) in enumerate(zip(procs, logs)):
        check(proc.returncode == 0 and os.path.exists(outs[r]), f"dist rank {r} failed ({proc.returncode}):\n{log}")
    ranks = [dict(np.load(o)) for o in outs]
    loss = float(ranks[0]["loss"])
    rel = abs(loss - ref_loss) / abs(ref_loss)
    grad_err = {}
    for k, ref in ref_grads.items():
        ref = ref.cpu().numpy()
        for rk in ranks:
            err = float(np.abs(rk[f"grad_{k}"] - ref).max() / max(np.abs(ref).max(), 1e-30))
            grad_err[k] = max(grad_err.get(k, 0.0), err)
    gat_err = [max(float(rk["gat_err"][i]) for rk in ranks) / max(max(float(rk["gat_max"][i]) for rk in ranks), 1e-30)
               for i in range(4)]
    per_rank = [{"interior_edges": int(rk["interior_edges"]), "frontier_edges": int(rk["frontier_edges"]),
                 "launches": json.loads(str(rk["counts"])), "rows_sent": int(rk["rows_sent"]),
                 "bytes_sent": int(rk["bytes_sent"]), "partition_s": float(rk["partition_s"]),
                 "step_s": [float(v) for v in rk["step_s"]]} for rk in ranks]
    where = "one card" if backend == "gloo" else f"{n_ranks} cards"
    print(f"dist-halo-2rank: {n_ranks} {backend} ranks on {where} in {wall_s:.1f} s; loss {loss:.7f} against "
          f"{ref_loss:.7f} at world size 1 (relative {rel:.2e}); gradients err/max "
          f"{ {k: f'{v:.2e}' for k, v in grad_err.items()} }; GAT {DIST_GAT_TILING[0]} x {DIST_GAT_TILING[1]} "
          f"kernel vs plain route err/max (out, d el, d er, d fs) {[f'{v:.2e}' for v in gat_err]}")
    for r, pr in enumerate(per_rank):
        print(f"  rank {r}: interior {pr['interior_edges']} edges, frontier {pr['frontier_edges']} edges, halo "
              f"{int(ranks[r]['halo_total'])} rows; a step launched {pr['launches']}, sent {pr['rows_sent']} "
              f"rows ({pr['bytes_sent']} bytes); step s {[round(v, 4) for v in pr['step_s']]}")
    losses_agree = all(abs(float(rk["loss"]) - loss) <= 1e-7 * abs(loss) for rk in ranks)
    ok = rel <= DIST_LOSS_TOL and losses_agree and max(grad_err.values()) <= DIST_TOL and max(gat_err) <= DIST_TOL
    check(ok, "the two-rank step or GAT attention disagrees with its reference")
    dyn, batch = dist_dyn_batch_vs_world_of_one(ranks, dyn_ref, batch_ref, n_ranks)
    for r, pr in enumerate(per_rank):
        splits = (pr["interior_edges"] > 0) + (pr["frontier_edges"] > 0)
        want = only(K1_traced=3 * splits, K1=3 * splits)  # each non-empty split forward and on its transpose
        check(pr["launches"] == want, f"rank {r} launched {pr['launches']} in a step, expected {want}")
        check(pr["rows_sent"] == 2 * 3 * int(ranks[r]["halo_total"]),
              f"rank {r} sent {pr['rows_sent']} halo rows in a step, expected 6 x {int(ranks[r]['halo_total'])}")
    return {"n_ranks": n_ranks, "backend": backend, "wall_s": wall_s, "loss": loss, "loss_world_of_one": ref_loss,
            "loss_rel_diff": rel,
            "grad_err_over_max": grad_err, "gat_err_over_max": gat_err, "ranks": per_rank, "dist_dyn": dyn,
            "batched_tgcn": batch}


def dist_dyn_batch_vs_world_of_one(ranks, dyn_ref, batch_ref, n_ranks):
    """The rank phase's ``parallel.dyn`` run (``DIST_DYN_SMALL``) against the
    same run at world size 1 (the ranks' outputs and gradients stacked, to
    ``DIST_TOL`` of each tensor's largest element; degrees and live counts
    exact; one K6 and one K7 a step on each rank), and its ``parallel.batch``
    runs on the (ranks x 1) and (1 x ranks) meshes against the sequential
    windows at world size 1 (loss and gradients to ``DIST_TOL``, the same on
    every rank; 3 K1_traced and 3 K1 a timestep of a window and split)."""
    nodes, steps = DIST_DYN_SMALL["nodes"], DIST_DYN_SMALL["steps"]
    out = np.concatenate([rk["dyn_out"] for rk in ranks])[:nodes]
    grad = np.concatenate([rk["dyn_grad"] for rk in ranks])[:nodes]
    deg = np.concatenate([rk["dyn_deg"] for rk in ranks])[:nodes]
    out_err = float(np.abs(out - dyn_ref["out"]).max() / max(np.abs(dyn_ref["out"]).max(), 1e-30))
    grad_err = float(np.abs(grad - dyn_ref["grad"]).max() / max(np.abs(dyn_ref["grad"]).max(), 1e-30))
    ne = sum(int(rk["dyn_ne"]) for rk in ranks)
    dyn_counts = [json.loads(str(rk["dyn_counts"])) for rk in ranks]
    print(f"  dist-dyn at {nodes} nodes, {steps} steps: {n_ranks} ranks against world size 1: output err/max "
          f"{out_err:.2e}, gradient err/max {grad_err:.2e} (tol {DIST_TOL:g}), degrees equal "
          f"{np.array_equal(deg, dyn_ref['deg'])}, live edges {ne} vs {dyn_ref['ne']}; a step "
          f"{[round(float(rk['dyn_step_s']) * 1e3, 3) for rk in ranks]} ms on the ranks, "
          f"{dyn_ref['step_s'] * 1e3:.3f} ms at world size 1; launches {dyn_counts}")
    check(out_err <= DIST_TOL and grad_err <= DIST_TOL and np.array_equal(deg, dyn_ref["deg"]) and ne == dyn_ref["ne"],
          "the ranks' dist-dyn run disagrees with world size 1")
    check(all(c == only(K6=steps, K7=steps) for c in dyn_counts), f"the ranks' dist-dyn launches {dyn_counts}")
    batch = {}
    for m in (f"{n_ranks}x1", f"1x{n_ranks}"):
        losses = [float(rk[f"batch_{m}_loss"]) for rk in ranks]
        loss_err = max(abs(v - batch_ref["loss"]) / abs(batch_ref["loss"]) for v in losses)
        g_err = {}
        for rk in ranks:
            got = {k: rk[f"batch_{m}_grad_{k}"] for k in batch_ref["grads"]}
            for k, v in _grads_err(got, batch_ref["grads"]).items():
                g_err[k] = max(g_err.get(k, 0.0), v)
        counts = [json.loads(str(rk[f"batch_{m}_counts"])) for rk in ranks]
        expected = [json.loads(str(rk[f"batch_{m}_expected"])) for rk in ranks]
        seconds = [float(rk[f"batch_{m}_s"]) for rk in ranks]
        print(f"  batched-tgcn {m} mesh: loss {losses} against the sequential windows' {batch_ref['loss']:.6f} "
              f"(relative {loss_err:.2e}), gradients err/max worst {max(g_err.values()):.2e} (tol {DIST_TOL:g}); "
              f"forward and backward {[round(v, 3) for v in seconds]} s; launches {counts}")
        check(loss_err <= DIST_TOL and max(g_err.values()) <= DIST_TOL,
              f"the batched TGCN on the {m} mesh disagrees with the sequential windows")
        check(counts == expected and all(c["K1_traced"] > 0 for c in counts),
              f"the batched TGCN on the {m} mesh launched {counts}, expected {expected}")
        batch[m] = {"losses": losses, "loss_rel_diff": loss_err, "grad_err_over_max": g_err, "seconds": seconds,
                    "launches": counts}
    return ({"out_err_over_max": out_err, "grad_err_over_max": grad_err, "live_edges": ne,
             "step_s": [float(rk["dyn_step_s"]) for rk in ranks], "update_s": [float(rk["dyn_update_s"]) for rk in ranks],
             "step_s_world_of_one": dyn_ref["step_s"], "launches": dyn_counts}, batch)


def kernel_entry(name, source, replaces, key, by_path, max_abs_err, per_launch, library=None, paths=None,
                 **extra):
    """One kernel's entry of the kernels line: launches summed over the main
    paths' runs (``paths``, default all: K1's and K2's one-head and heads
    modes, and K8's and K9's modes with and without dropout, count on their
    own paths), times summed over the launches of one request (K1, K4) or
    one training step (K2, K8 with its aux outputs, K9, each also in the
    dropout mode; K3 and K10: a step of the PPI GAT; K5, the no-gather sum
    and the heads modes: a step of the rowmask route at PPI size) at the
    main path's shapes."""
    by_path = {path: counts for path, counts in by_path.items() if paths is None or path in paths}
    if all(p.get("library_heads_ms") is not None for p in per_launch):  # H per-head calls (K10, K1 heads)
        extra["library_heads_ms"] = sum(p["library_heads_ms"] for p in per_launch)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": sum(counts[key] for counts in by_path.values()),
        "launches_by_path": {path: counts[key] for path, counts in by_path.items()},
        "max_abs_err": max_abs_err,
        "ms": sum(p["ms"] for p in per_launch),
        "plain_ms": sum(p["plain_ms"] for p in per_launch),
        "bound_ms": sum(p["bound_ms"] for p in per_launch),
        "bound_by": "bytes" if all(p["bound_by"] == "bytes" for p in per_launch) else "operations",
        "library_ms": (None if any(p["library_ms"] is None for p in per_launch)
                       else sum(p["library_ms"] for p in per_launch)),
        "library": library,
        "per_launch": [{k: p[k] for k in ("where", "layout", "H", "F", "aux", "stream", "longest_item", "ms",
                                          "plain_ms", "bound_ms", "library_ms", "library_heads_ms") if k in p}
                       for p in per_launch],
        **extra,
    }


def write_details(record, args) -> None:
    """``record``, with every phase's seconds, to ``--details`` if given."""
    record["phase_s"] = PHASE_SECONDS
    if args.details:
        os.makedirs(os.path.dirname(os.path.abspath(args.details)), exist_ok=True)
        with open(args.details, "w") as fh:
            json.dump(record, fh, indent=1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scale", type=float, default=1.0, help="synthetic ogbn-products scale")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--details", help="write every measurement of the run to this JSON file")
    ap.add_argument("--dist-worker", help=argparse.SUPPRESS)  # RANK,WORLD,PORT,OUT,BACKEND: one rank of dist-halo
    ap.add_argument("--trace-worker", help=argparse.SUPPRESS)  # LOGDIR: the utilities phase's fresh process
    ap.add_argument("--dist-ranks", type=int,
                    help="run only dist-halo-2rank, with this many ranks (NCCL on a card each where there are enough)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import stgraph_tpu_torch as port
    except ImportError as exc:
        print(f"chip_smoke: cannot import the port from {ROOT}: {exc}", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 GEMMs stay f32 (the reference's arithmetic)
    if args.dist_worker:
        rank, world, port, out, backend = args.dist_worker.split(",")
        dist_worker(int(rank), int(world), int(port), out, args.seed, backend)
        return 0
    if args.trace_worker:
        trace_worker(dev, args.trace_worker)
        return 0
    rng = np.random.default_rng(args.seed)
    record = {"args": vars(args)}
    build_root = os.path.join(ROOT, "build")
    os.makedirs(build_root, exist_ok=True)
    t_start = time.perf_counter()
    try:
        record["environment"] = phase_environment(port)
        if args.dist_ranks:  # only the rank phase; no kernels line
            with tempfile.TemporaryDirectory(dir=build_root) as workdir:
                record["dist_halo_2rank"] = phase_dist_halo_2rank(dev, args, workdir, args.dist_ranks)
            write_details(record, args)
            print(record["environment"]["nvidia_smi"])
            print(json.dumps({"dist_halo_2rank": record["dist_halo_2rank"]}))
            return 0
        record["k1_checks"] = phase_k1_vs_plain(dev, rng)
        record["k2_checks"] = phase_k2_vs_plain(dev, rng)
        record["gat_checks"] = phase_gat_kernels_vs_plain(dev, rng)
        with tempfile.TemporaryDirectory(dir=build_root) as workdir:
            served = phase_serving(dev, args, workdir)
            record["serving"] = served["record"]
            k1_launch, k1_err = phase_k1_at_main_shapes(served)
            record["k1_main"] = k1_launch
            record["profile"] = phase_profile(lambda: served["predictor"](served["feats"]), "one request")
            k2_launch, k2_err, record["k2_setup"] = phase_k2_at_main_shapes(served)
            record["k2_main"] = k2_launch
            trained = phase_training(dev, args, served)
            record["training"] = trained["record"]
            record["checkpoint_serve"] = phase_checkpoint_serve(dev, served, trained, workdir)
            record["training_profile"] = phase_profile(trained["step"], "one training step")
            record["unweighted_step"] = phase_unweighted_step(dev, args, served)
            # The GAT phases run on the graph the GCN phases built; the GCN
            # models, predictors and optimizer states go first.
            base = {k: served[k] for k in ("graph", "feats", "labels")}
            gcn_counts = served["counts"]
            del served, trained
            torch.cuda.empty_cache()
            record["dist_gcn_training"] = phase_dist_gcn_training(dev, args, base)
            record["ogbn_reorder"] = phase_ogbn_reorder(dev, args, workdir, base, record["environment"]["nvidia_smi"])
            gat = phase_gat_serving(dev, args, base)
            record["gat_serving"] = gat["record"]
            gat_launch, gat_err = phase_gat_kernels_at_main_shapes(dev, gat)
            record["gat_main"] = gat_launch
            del gat
            torch.cuda.empty_cache()
            gat_trained = phase_gat_training(dev, args, base)
            record["gat_training"] = gat_trained["record"]
            record["gat_training_profile"] = phase_profile(gat_trained["step"], "one GAT training step")
            gat_train_counts = gat_trained["counts"]
            del gat_trained
            torch.cuda.empty_cache()
            gat_dropout = phase_gat_dropout_training(dev, args, base)
            record["gat_dropout_training"] = gat_dropout["record"]
            del gat_dropout
            torch.cuda.empty_cache()
            composed = phase_composed_ogbn_serving(dev, args, base)
            record["composed_serving"] = composed["record"]
            del base
            torch.cuda.empty_cache()
            record["model_check"] = phase_model_vs_plain(dev, args, workdir)
            record["grad_check"] = phase_grads_vs_plain(dev, args, workdir)
            record["gat_check"] = phase_gat_vs_plain(dev, args, workdir)
            record["gat_dropout_check"] = phase_gat_dropout_vs_plain(dev, args, workdir)
            record["dist_check"] = phase_dist_vs_plain(dev, args, workdir)
            record["cora"] = phase_cora(dev, args, workdir)
            record["pubmed_gat"] = phase_pubmed_gat(dev, args, workdir)
            record["pubmed_rowmask"] = phase_pubmed_rowmask(dev, args, workdir)
        record["tgcn"] = phase_tgcn(dev, rng)
        # The composed GAT route at PPI size, the ogbn graph released
        record["composed_checks"] = phase_composed_kernels_vs_plain(dev, np.random.default_rng(args.seed + 5))
        record["rowmask_checks"] = phase_rowmask_kernels_vs_plain(dev, np.random.default_rng(args.seed + 7))
        record["dist_k1_traced_checks"] = phase_dist_k1_traced_checks(dev, np.random.default_rng(args.seed + 9))
        ppi = phase_ppi_gat(dev, args)
        record["ppi"] = ppi["record"]
        composed_launch, composed_err = phase_composed_at_main_shapes(dev, ppi)
        record["composed_main"] = composed_launch
        rowmask_ppi = phase_rowmask_ppi(dev, ppi)
        record["rowmask_ppi"] = {k: v for k, v in rowmask_ppi.items() if k != "per_launch"}
        record["rowmask_main"] = rowmask_ppi["per_launch"]
        del ppi
        torch.cuda.empty_cache()
        # The dynamic-graph phases, the ogbn graph and models released
        record["rowid_checks"] = phase_rowid_kernels_vs_plain(dev, rng)
        dyn = phase_dyn_step(dev, args.seed)
        record["dyn_step"] = dyn["record"]
        rowid_launch, rowid_err = phase_rowid_at_main_shapes(dyn)
        record["rowid_main"] = rowid_launch
        dyn_stream_data = dyn["stream"]  # the dist-dyn phase's workload
        del dyn
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(dir=build_root) as workdir:
            record["dtdg_training"] = {name: phase_dtdg_training(dev, args, workdir, name)
                                       for name in DTDG_DATASETS}
            # The temporal drivers: bench.py's TGCN epoch, the static-temporal
            # script on WikiMath (dense) and WindmillOutput large (K1, K2), the
            # dynamic-temporal script's snapshot and delta types
            record["tgcn_epoch"] = phase_tgcn_epoch(dev, args, workdir)
            static = {run[0]: phase_static_temporal(dev, args, workdir, *run) for run in STATIC_RUNS}
            record["static_temporal"] = {name: r["record"] for name, r in static.items()}
            record["static_temporal_checks"] = phase_static_temporal_checks(dev, args, static["windmill_large"])
            del static
            torch.cuda.empty_cache()
            record["dynamic_temporal"] = {name: phase_dynamic_temporal(dev, args, workdir, name)
                                          for name in DTDG_DATASETS}
            # The PMA store, distributed dynamic graphs and 2-D window batches
            record["pma_scan"] = {name: phase_pma_scan(dev, args, workdir, name) for name in DTDG_DATASETS}
            record["dist_dyn"] = phase_dist_dyn(dev, args, dyn_stream_data)
            del dyn_stream_data
            torch.cuda.empty_cache()
            record["batched_tgcn"] = phase_batched_tgcn(dev, args, workdir)
            # EvolveGCN's two variants, segment_sum_edges and the utilities
            evolve = phase_evolvegcn(dev, args, workdir)
            record["evolvegcn"], record["evolvegcn_main"] = evolve["runs"], evolve["per_launch"]
            record["segment_sum_edges"] = phase_segment_sum_edges(dev, np.random.default_rng(args.seed + 11))
            record["utilities"] = phase_utilities(dev, workdir, evolve["loss"])
            del evolve
            record["dist_halo_2rank"] = phase_dist_halo_2rank(dev, args, workdir)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    by_path = {"serving": gcn_counts, "training": record["training"]["launches"],
               "gat-serving": record["gat_serving"]["launches"], "gat-training": gat_train_counts,
               "gat-dropout-training": record["gat_dropout_training"]["launches"],
               "composed-serving": composed["counts"], "ppi-serving": record["ppi"]["serve_launches"],
               "ppi-training": record["ppi"]["train_launches"], "dyn-step": record["dyn_step"]["launches"],
               "pubmed-rowmask": record["pubmed_rowmask"]["launches"], "rowmask-ppi": rowmask_ppi["counts"],
               "dist-gcn-training": record["dist_gcn_training"]["launches"]}
    by_path.update({f"dtdg-training:{name}": r["launches"] for name, r in record["dtdg_training"].items()})
    by_path["tgcn-epoch"] = record["tgcn_epoch"]["launches"]
    by_path.update({f"static-temporal:{name}": r["launches"] for name, r in record["static_temporal"].items()})
    by_path.update({f"dynamic-temporal:{name}:{kind}": r["launches"]
                    for name, rec in record["dynamic_temporal"].items() for kind, r in rec["runs"].items()})
    by_path.update({f"pma-scan:{name}": r["launches"] for name, r in record["pma_scan"].items()})
    by_path["dist-dyn"] = record["dist_dyn"]["launches"]
    by_path["batched-tgcn"] = record["batched_tgcn"]["launches"]
    by_path.update({f"evolvegcn:{variant}": r["launches"] for variant, r in record["evolvegcn"].items()})
    temporal = record["static_temporal_checks"]["per_launch"]
    wiki_temporal = record["dynamic_temporal"]["wiki-shape"]["per_launch"]
    evolve_main = record["evolvegcn_main"]
    seg_edges = record["segment_sum_edges"]
    seg_edges_shapes = {key: {p["where"]: p for p in seg_edges["per_launch"] if p["kernel"] == key}
                        for key in ("K3", "K1_nogather")}
    rowmask_paths = ("pubmed-rowmask", "rowmask-ppi")
    dist_paths = ("dist-gcn-training", "batched-tgcn")
    one_head_paths = tuple(path for path in by_path if path not in rowmask_paths + dist_paths)
    dropout_paths = ("gat-dropout-training",)
    undropped_paths = tuple(path for path in by_path if path not in dropout_paths)
    rowmask_main, rowmask_checks = rowmask_ppi["per_launch"], record["rowmask_checks"]["max_abs_err"]
    dist_main = record["dist_gcn_training"]["per_launch"]
    h, f = ROWMASK_PPI_TILING
    # the designs of the kernels redesigned for Hopper: the port's, and the
    # first one it replaced, timed against it in turns by benchmarking/micro/
    k2_designs = {"port": "K1's lane groups (one 16 B load a lane, 32 / G edges a step, a round's gathers ahead), "
                          "packed bf16x2 products, dw folded within each group by a transpose reduction and "
                          "stored 32 edges a line; items of K2_CHUNK edges",
                  "first": "a warp an edge, lanes across the row, a five-shuffle dot an edge, 1024-edge items;"
                           " timed in turns by benchmarking/micro/k2_k4_bench.py --only turns"}
    k4_designs = {"port": "16 lanes an item, kU edges a lane in flight with the next batch's indices "
                          "loaded ahead, vector row loads, a transpose meeting, split rows finished by a ticket "
                          "(one launch); items of K4_CHUNK edges",
                  "first": "a warp a row, one edge a lane an iteration, 5 shuffles a column, a second launch for "
                           "split rows; timed in turns by benchmarking/micro/k2_k4_bench.py --only turns"}
    k3_designs = {"port": "K4's design with a sum: int4 items of K3_CHUNK edges (split rows' first), 8 lanes an "
                          "item, kU edges a lane in flight, vector row loads, a transpose meeting, split rows summed "
                          "in a fixed order from scratch slots by the last item's ticket (one launch, the same sums "
                          "every run)",
                  "first": "a warp a 1024-edge item, one edge a lane an iteration, 5 shuffles a column, split rows "
                           "by atomicAdd after an index_fill_ launch; timed in turns by "
                           "benchmarking/micro/k3_bench.py --only turns"}
    kernels = [
        kernel_entry("spmm_rowmask (K1, one head: H=1, F=128, 128, 47, bf16 stream)",
                     "stgraph_tpu_torch/csrc/spmm_rowmask.cu", "stgraph_tpu/ops/segment_pallas.py:761", "K1", by_path,
                     max(record["k1_checks"]["max_abs_err"], k1_err, temporal["K1"]["max_abs_err"],
                         wiki_temporal["K1"]["max_abs_err"], evolve_main["K1"]["max_abs_err"]),
                     [dict(p, H=1) for p in k1_launch], paths=one_head_paths, temporal_shape=temporal["K1"],
                     temporal_wiki_shape=wiki_temporal["K1"], evolvegcn_shape=evolve_main["K1"]),
        kernel_entry(f"spmm_rowmask (K1, heads and denominator: H={h}, F={f}, bf16 stream at PPI size, f32 on "
                     "Pubmed)", "stgraph_tpu_torch/csrc/spmm_rowmask.cu", "stgraph_tpu/ops/segment_pallas.py:761",
                     "K1", by_path, max(rowmask_checks["K1"], rowmask_ppi["max_abs_err"]["K1"]), rowmask_main["K1"],
                     rowmask_main["K1"][0]["library"], paths=rowmask_paths),
        kernel_entry("spmm_sddmm_rowmask (K2, one head: H=1, F=128, 128, 47, bf16 stream)",
                     "stgraph_tpu_torch/csrc/spmm_sddmm_rowmask.cu",
                     "stgraph_tpu/ops/segment_pallas.py:1248", "K2", by_path,
                     max(record["k2_checks"]["max_abs_err"], k2_err, record["dist_k1_traced_checks"]["max_abs_err"]["K2"],
                         temporal["K2"]["max_abs_err"], wiki_temporal["K2"]["max_abs_err"],
                         evolve_main["K2"]["max_abs_err"]),
                     # a training step's three launches: F = 128, 128, 47
                     [dict(p, H=1) for f_ in (128, 128, 47) for p in k2_launch if p["F"] == f_],
                     paths=one_head_paths, designs=k2_designs, temporal_shape=temporal["K2"],
                     temporal_wiki_shape=wiki_temporal["K2"], evolvegcn_shape=evolve_main["K2"]),
        kernel_entry(f"spmm_sddmm_rowmask (K2, heads: H={h}, F={f}, bf16 stream at PPI size, f32 on Pubmed)",
                     "stgraph_tpu_torch/csrc/spmm_sddmm_rowmask.cu", "stgraph_tpu/ops/segment_pallas.py:1248", "K2",
                     by_path, max(rowmask_checks["K2"], rowmask_ppi["max_abs_err"]["K2"]), rowmask_main["K2"],
                     rowmask_main["K2"][0]["library"], paths=rowmask_paths, designs=k2_designs),
        kernel_entry(f"segment_sum_wide (K1's no-gather mode, K={h}, bf16 stream at PPI size, f32 on Pubmed)",
                     "stgraph_tpu_torch/csrc/segment_sum_wide.cu", "stgraph_tpu/ops/segment_pallas.py:710",
                     "K1_nogather", by_path, max(rowmask_checks["K1_nogather"],
                                                 rowmask_ppi["max_abs_err"]["K1_nogather"],
                                                 seg_edges["max_abs_err"]["K1_nogather"]),
                     rowmask_main["K1_nogather"], rowmask_main["K1_nogather"][0]["library"],
                     by_shape=seg_edges_shapes["K1_nogather"]),
        kernel_entry(f"segment_max_wide (K5, K={h})", "stgraph_tpu_torch/csrc/segment_max_wide.cu",
                     "stgraph_tpu/ops/segment_pallas.py:466", "K5", by_path, rowmask_ppi["max_abs_err"]["K5"],
                     rowmask_main["K5"], rowmask_main["K5"][0]["library"],
                     by_shape={"pubmed": record["pubmed_rowmask"]["k5"], "ppi": rowmask_main["K5"][0]}),
        kernel_entry("segment_sum_narrow (K3)", "stgraph_tpu_torch/csrc/segment_sum_narrow.cu",
                     "stgraph_tpu/ops/segment_pallas.py:155", "K3", by_path,
                     max(record["composed_checks"]["max_abs_err"]["K3"], composed_err["K3"],
                         composed["max_abs_err"]["K3"], seg_edges["max_abs_err"]["K3"]), composed_launch["K3"],
                     "torch.segment_reduce(sum) over the CSR-order (E, H) plane", designs=k3_designs,
                     by_shape={**composed_launch["K3_by_shape"], "ogbn forward K=4": composed["main"]["K3"],
                               **seg_edges_shapes["K3"]}),
        kernel_entry("segment_max_narrow (K4)", "stgraph_tpu_torch/csrc/segment_max_narrow.cu",
                     "stgraph_tpu/ops/segment_pallas.py:235", "K4", by_path,
                     max(record["gat_checks"]["max_abs_err"]["K4"], gat_err["K4"]), gat_launch["K4"],
                     "torch.segment_reduce(max) over the gathered (E, H) plane", designs=k4_designs),
        kernel_entry("spmm_rowid (K6)", "stgraph_tpu_torch/csrc/spmm_rowid.cu",
                     "stgraph_tpu/ops/segment_pallas.py:1673", "K6", by_path,
                     max(record["rowid_checks"]["max_abs_err"]["K6"], rowid_err["K6"],
                         *(r["kernel_max_abs_err"]["K6"] for r in record["dtdg_training"].values()),
                         *(k["max_abs_err"] for r in record["pma_scan"].values()
                           for name, k in r["kernels"].items() if name.startswith("K6")),
                         record["dist_dyn"]["out_max_abs_err"]),
                     rowid_launch["K6"],
                     "torch.sparse.mm on a CSR built from the store (the build timed apart)",
                     kernels_per_call=2, kernels_of_a_call=["rowid_chunk_plan_kernel", "spmm_rowid_kernel"],
                     by_shape={f"pma-scan:{name}:{side}": r["kernels"][f"K6_{side}"]
                               for name, r in record["pma_scan"].items() for side in ("fwd", "bwd")}),
        kernel_entry("rowid_denom (K7)", "stgraph_tpu_torch/csrc/rowid_denom.cu",
                     "stgraph_tpu/ops/dyn_spmm.py:382", "K7", by_path,
                     max(record["rowid_checks"]["max_abs_err"]["K7"], rowid_err["K7"]), rowid_launch["K7"],
                     "torch.bincount(rows, weights, minlength=n + 1)",
                     by_shape={**{name: r["k7"] for name, r in record["dtdg_training"].items()},
                               "dyn-step": rowid_launch["K7"][0],
                               **{f"pma-scan:{name}": r["kernels"]["K7"] for name, r in record["pma_scan"].items()}}),
        kernel_entry("flash_gat_fwd (K8)", "stgraph_tpu_torch/csrc/flash_gat_fwd.cu",
                     "stgraph_tpu/ops/flash_gat.py:191", "K8", by_path,
                     max(record["gat_checks"]["max_abs_err"]["K8"], gat_err["K8"]), gat_launch["K8"],
                     "torch.sparse.softmax + torch.sparse.mm, per head", paths=undropped_paths),
        kernel_entry("flash_gat_bwd (K9)", "stgraph_tpu_torch/csrc/flash_gat_bwd.cu",
                     "stgraph_tpu/ops/flash_gat.py:365", "K9", by_path,
                     max(record["gat_checks"]["max_abs_err"]["K9"], gat_err["K9"]), gat_launch["K9"],
                     paths=undropped_paths),
        kernel_entry(f"flash_gat_fwd (K8, dropout mode: attn_drop {GAT_ATTN_DROP}, aux, bf16 stream)",
                     "stgraph_tpu_torch/csrc/flash_gat_fwd.cu", "stgraph_tpu/ops/flash_gat.py:191", "K8_dropout",
                     by_path, max(record["gat_checks"]["max_abs_err"]["K8_dropout"], gat_err["K8_dropout"]),
                     gat_launch["K8_dropout"], paths=dropout_paths),
        kernel_entry(f"flash_gat_bwd (K9, dropout mode: attn_drop {GAT_ATTN_DROP}, bf16 stream)",
                     "stgraph_tpu_torch/csrc/flash_gat_bwd.cu", "stgraph_tpu/ops/flash_gat.py:365", "K9_dropout",
                     by_path, max(record["gat_checks"]["max_abs_err"]["K9_dropout"], gat_err["K9_dropout"]),
                     gat_launch["K9_dropout"], paths=dropout_paths),
        kernel_entry("spmm_rowmask_traced (K1's shard mode: H=1, F=64, 64, 47, f32 stream; and 160 in the "
                     "batched TGCN)",
                     "stgraph_tpu_torch/csrc/spmm_rowmask.cu", "stgraph_tpu/ops/segment_pallas.py:1136", "K1_traced",
                     by_path, max(record["dist_k1_traced_checks"]["max_abs_err"]["K1_traced"],
                                  *(p["max_abs_err"] for p in dist_main["K1_traced"])),
                     dist_main["K1_traced"], "torch.sparse.mm on the shard CSR", paths=dist_paths),
        kernel_entry("spmm_rowmask (K1 on the shard transposes: H=1, F=64, 64, 47, f32 stream; and 160 in the "
                     "batched TGCN)",
                     "stgraph_tpu_torch/csrc/spmm_rowmask.cu", "stgraph_tpu/ops/segment_pallas.py:761", "K1", by_path,
                     max(p["max_abs_err"] for p in dist_main["K1"]), dist_main["K1"],
                     "torch.sparse.mm on the transpose CSR", paths=dist_paths),
        kernel_entry("segment_sum_blocked (K10)", "stgraph_tpu_torch/csrc/segment_sum_blocked.cu",
                     "stgraph_tpu/ops/spmm_pallas.py:61", "K10", by_path,
                     max(record["composed_checks"]["max_abs_err"]["K10"], composed_err["K10"],
                         composed["max_abs_err"]["K10"]), composed_launch["K10"],
                     "torch.sparse.mm, one call over the block-diagonal-by-head pattern (library_heads_ms: one "
                     "call a head)"),
    ]
    record["kernels"] = kernels
    record["total_s"] = time.perf_counter() - t_start
    write_details(record, args)
    print(f"total {record['total_s']:.1f} s; longest phases " + ", ".join(
        f"{name} {sec:.1f} s" for name, sec in sorted(PHASE_SECONDS, key=lambda p: -p[1])[:8]))
    print(record["environment"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
