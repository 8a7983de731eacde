"""The temporal training drivers, the counterparts of the JAX package's
benchmark scripts:

  * ``static_temporal_tgcn``: ``benchmarking/static-temporal-tgcn/train.py``
    (TGCN regression over a fixed graph, truncated BPTT, ``--remat``) and
    ``bench.py``'s ``bench_tgcn_epoch``;
  * ``dynamic_temporal_tgcn``: ``benchmarking/dynamic-temporal-tgcn/train.py``
    (TGCN link prediction over a changing graph: ``--type naive``,
    ``delta``, ``delta-scan``, ``lazy-scan`` and ``pma-scan``);
  * ``evolvegcn``: ``benchmarking/evolvegcn/train.py`` (EvolveGCN-O or -H
    regression with the GCN weight evolved across the timesteps, full
    BPTT, one Adam step an epoch).

Each runs as ``python -m stgraph_tpu_torch.drivers.<name>`` with its
script's flags, on CUDA unless ``--cpu`` is given, and exposes the function
the flags call.
"""
