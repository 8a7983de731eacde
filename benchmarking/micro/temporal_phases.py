#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s temporal phases alone on one NVIDIA GPU, at their
full size: the kernels' build, then (``--only``, in this order)

- ``dtdg``: ``phase_dtdg_training`` on England-COVID and the
  wiki-talk-shaped stream (the lazy-scan type);
- ``tgcn-epoch``: ``phase_tgcn_epoch`` (``bench.py``'s TGCN epoch);
- ``static``: ``phase_static_temporal`` on every run of ``STATIC_RUNS``
  (WikiMath on the dense route, WindmillOutput large on K1 and K2), then
  ``phase_static_temporal_checks`` on the WindmillOutput run;
- ``dynamic``: ``phase_dynamic_temporal`` on both DTDG datasets (the naive,
  delta and delta-scan types);
- ``pma``: ``phase_pma_scan`` on both DTDG datasets (the pma-scan type);
- ``dist-dyn``: ``phase_dist_dyn`` (``parallel.dyn`` at the dyn-step shape);
- ``batched``: ``phase_batched_tgcn`` (``parallel.batch`` on a 1 x 1 mesh);
- ``ranks``: ``phase_dist_halo_2rank`` (two processes on the card, with
  ``parallel.dyn`` and ``parallel.batch`` against world size 1).

Each phase prints what it prints in ``chip_smoke.py`` and runs the same
checks; a phase that fails ends the run with code 1. Last, the seconds of
every phase and of the whole run, and the card's name and power limit.

    python3 benchmarking/micro/temporal_phases.py [--only dtdg,tgcn-epoch,static,dynamic,pma,dist-dyn,batched,ranks]
        [--seed N] [--out PATH]

``--out`` writes every phase's record and its seconds as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASES = ("dtdg", "tgcn-epoch", "static", "dynamic", "pma", "dist-dyn", "batched", "ranks")
TEMPORAL_PHASES = ("phase_tgcn_epoch", "phase_static_temporal", "phase_static_temporal_checks", "phase_dynamic_temporal")
SLICE_PHASES = ("phase_pma_scan", "phase_dist_dyn", "phase_batched_tgcn")  # the PMA and parallel.dyn/batch phases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", default=",".join(PHASES), help="comma-separated phases")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="write the records as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("temporal_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import stgraph_tpu_torch as port

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py: f32 GEMMs stay f32
    phases = args.only.split(",")
    t0 = time.perf_counter()
    record = {"environment": cs.phase_environment(port)}
    status = 0
    build_root = os.path.join(ROOT, "build")
    os.makedirs(build_root, exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=build_root) as workdir:
            if "dtdg" in phases:
                record["dtdg_training"] = {name: cs.phase_dtdg_training(dev, args, workdir, name)
                                           for name in cs.DTDG_DATASETS}
            if "tgcn-epoch" in phases:
                record["tgcn_epoch"] = cs.phase_tgcn_epoch(dev, args, workdir)
            if "static" in phases:
                static = {run[0]: cs.phase_static_temporal(dev, args, workdir, *run) for run in cs.STATIC_RUNS}
                record["static_temporal"] = {name: r["record"] for name, r in static.items()}
                record["static_temporal_checks"] = cs.phase_static_temporal_checks(dev, args,
                                                                                   static["windmill_large"])
                del static
                torch.cuda.empty_cache()
            if "dynamic" in phases:
                record["dynamic_temporal"] = {name: cs.phase_dynamic_temporal(dev, args, workdir, name)
                                              for name in cs.DTDG_DATASETS}
            if "pma" in phases:
                record["pma_scan"] = {name: cs.phase_pma_scan(dev, args, workdir, name) for name in cs.DTDG_DATASETS}
            if "dist-dyn" in phases:
                record["dist_dyn"] = cs.phase_dist_dyn(dev, args)
                torch.cuda.empty_cache()
            if "batched" in phases:
                record["batched_tgcn"] = cs.phase_batched_tgcn(dev, args, workdir)
            if "ranks" in phases:
                record["dist_halo_2rank"] = cs.phase_dist_halo_2rank(dev, args, workdir)
    except cs.SmokeFailure as exc:
        print(f"temporal_phases: FAILED: {exc}", file=sys.stderr)
        status = 1
    record["phase_s"] = cs.PHASE_SECONDS
    total = time.perf_counter() - t0
    temporal = sum(s for name, s in cs.PHASE_SECONDS if name in TEMPORAL_PHASES)  # phase_profile runs inside
    new = sum(s for name, s in cs.PHASE_SECONDS if name in SLICE_PHASES)
    print("phases " + ", ".join(f"{name} {s:.1f} s" for name, s in cs.PHASE_SECONDS)
          + f"; the temporal drivers' phases {temporal:.1f} s; pma-scan, dist-dyn and batched-tgcn {new:.1f} s; "
          f"whole run {total:.1f} s")
    print(record["environment"]["nvidia_smi"])
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1, default=str)
    return status


if __name__ == "__main__":
    sys.exit(main())
