"""EvolveGCN's loss over the script's whole run, the port against JAX.

``chip_smoke.py``'s ``evolvegcn`` phase trains both variants for the
script's 10 epochs on WikiMath (723 timesteps, ``--feat_size 8
--num_hidden 32``, one Adam step an epoch, full BPTT) from
``EvolveGCNTrainer``'s seed-0 parameters. This script runs that same run on
the CPU twice from one set of parameters: once on the port
(``drivers.evolvegcn --impl kernel``: K1 and K2's plain versions) and once
on ``benchmarking/evolvegcn/train.py``'s recipe in JAX (its ``lax.scan``
epoch under ``jax.jit``), the port's parameters carried into JAX's tree and
the port loader's graph and targets into JAX's graph. It prints both
trajectories per epoch with their relative difference, and writes them to
``--out`` as JSON.

The parameters are the trainer's from seed 0, or, with ``--init``, the
ones a ``chip_smoke.py --details`` run recorded (its data's checksums are
checked against the synthetic WikiMath, and its losses are printed
beside). ``--perturb e`` adds a JAX run from every parameter times (1 + e):
how far a rounding-sized change carries over the run. It needs both
packages:

    JAX_PLATFORMS=cpu python tools/evolvegcn_trajectory.py --out traj.json
    JAX_PLATFORMS=cpu python tools/evolvegcn_trajectory.py --init chip_smoke.json --perturb 1e-7
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import flax.linen as fnn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from stgraph_tpu import StaticGraph as JaxStaticGraph  # noqa: E402
from stgraph_tpu.nn import EvolveGCNH as JaxEvolveGCNH  # noqa: E402
from stgraph_tpu.nn import EvolveGCNO as JaxEvolveGCNO  # noqa: E402
from stgraph_tpu_torch.dataset import STGraphDataset  # noqa: E402
from stgraph_tpu_torch.drivers import evolvegcn as EV  # noqa: E402

GRU_MAPS = ("wz_x", "wz_h", "wr_x", "wr_h", "wh_x", "wh_h")
LAGS, HIDDEN, LR, EPOCHS = 8, 32, 1e-2, 10  # the script's defaults, as chip_smoke.py runs them


def jax_tree(conv, head):
    """The port's conv and head parameters as flax trees (the inverse of
    ``convert.evolvegcn_params_from_jax`` and ``linear_params_from_jax``)."""
    sd = {k: v.detach().cpu().numpy() for k, v in conv.state_dict().items()}
    tree = {"weight": sd["weight"], "gru": {}}
    if "summarize_p" in sd:
        tree["summarize_p"] = sd["summarize_p"]
    for name in GRU_MAPS:
        dense = {"kernel": sd[f"gru.{name}.weight"].T.copy()}
        if f"gru.{name}.bias" in sd:
            dense["bias"] = sd[f"gru.{name}.bias"]
        tree["gru"][name] = dense
    hd = {k: v.detach().cpu().numpy() for k, v in head.state_dict().items()}
    return ({"params": jax.tree_util.tree_map(jnp.asarray, tree)},
            {"params": {"kernel": jnp.asarray(hd["weight"].T.copy()), "bias": jnp.asarray(hd["bias"])}})


def jax_losses(d, variant, params, hp):
    """``train.py``'s epochs (lines 78-100) on the loader ``d``'s graph and
    targets, from the given parameters."""
    n = d.gdata["num_nodes"]
    g = JaxStaticGraph(d.get_edges(), d.get_edge_weights(), n)
    targets = np.stack(d.get_all_targets()).astype(np.float32)
    t_steps = targets.shape[0] - LAGS
    feats = jnp.asarray(np.stack([targets[i:i + LAGS].T for i in range(t_steps)]))
    ys = jnp.asarray(targets[LAGS:])
    conv = (JaxEvolveGCNO if variant == "o" else JaxEvolveGCNH)(LAGS, HIDDEN)
    head = fnn.Dense(1)
    opt = optax.adam(LR)

    @jax.jit
    def epoch(ps, opt_state):
        def loss_fn(ps):
            params, hp = ps

            def body(w, xy):
                out, w = conv.apply(params, g, xy[0], weight=w)
                return w, jnp.mean((head.apply(hp, jax.nn.relu(out))[:, 0] - xy[1]) ** 2)

            return jax.lax.scan(body, params["params"]["weight"], (feats, ys))[1].mean()

        loss, grads = jax.value_and_grad(loss_fn)(ps)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(ps, updates), opt_state, loss

    ps = (params, hp)
    opt_state, losses = opt.init(ps), []
    for _ in range(EPOCHS):
        ps, opt_state, loss = epoch(ps, opt_state)
        losses.append(float(loss))
    return t_steps, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", default=None,
                    help="chip_smoke.py's --details JSON: start from its evolvegcn phase's parameters, check its "
                         "data's checksums, and print its losses beside these")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="also run JAX from every parameter times (1 + this): how far rounding-sized changes "
                         "carry over the run")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    STGraphDataset._offline = True  # no cache gives the synthetic data, no download
    d = EV.load_evolvegcn_dataset("wikimath", LAGS, None)
    chip = json.load(open(args.init))["evolvegcn"] if args.init else {}
    record = {"args": vars(args), "variants": {}}
    for variant in ("o", "h"):
        tr = EV.EvolveGCNTrainer(d, variant, LAGS, HIDDEN, LR, "kernel", "cpu", seed=0)
        run = chip.get(variant)
        if run:
            sums = {"targets_f64_sum": float(tr.ys.double().sum()),
                    "targets_f64_abs_sum": float(tr.ys.double().abs().sum()),
                    "csr_rows_sum": int(tr.graph.fwd_csr.rows.long().sum()),
                    "csr_cols_sum": int(tr.graph.fwd_csr.cols.long().sum())}
            if sums != run["data"]:
                raise SystemExit(f"the data differs from the chip run's: {sums} against {run['data']}")
            for prefix, mod in (("conv.", tr.conv), ("head.", tr.head)):
                mod.load_state_dict({k[len(prefix):]: torch.tensor(v) for k, v in run["init"].items()
                                     if k.startswith(prefix)})
        params, hp = jax_tree(tr.conv, tr.head)
        t = time.perf_counter()
        t_steps, ref = jax_losses(d, variant, params, hp)
        jax_s = time.perf_counter() - t
        assert t_steps == tr.total, (t_steps, tr.total)
        nudged = [None] * EPOCHS
        if args.perturb:
            nudge = lambda tree: jax.tree_util.tree_map(lambda a: a * (1 + args.perturb), tree)  # noqa: E731
            nudged = jax_losses(d, variant, nudge(params), nudge(hp))[1]
        t = time.perf_counter()
        port = [tr.epoch().item() for _ in range(EPOCHS)]
        port_s = time.perf_counter() - t
        rel = [abs(a - b) / abs(b) for a, b in zip(port, ref)]
        on_chip = run["loss"][:EPOCHS] if run else [None] * EPOCHS
        chip_rel = [None if c is None else abs(c - b) / abs(b) for c, b in zip(on_chip, ref)]
        print(f"EvolveGCN-{variant.upper()}: WikiMath, T={t_steps} timesteps, F={LAGS} H={HIDDEN}, lr {LR}, "
              f"from {'the chip run' if run else 'seed 0'}'s parameters, port --impl kernel (CPU {port_s:.1f} s, "
              f"JAX {jax_s:.1f} s)")
        for i, (a, b, r, c, cr, p) in enumerate(zip(port, ref, rel, on_chip, chip_rel, nudged)):
            line = f"  epoch {i}: port {a:.6f}  jax {b:.6f}  |diff|/|jax| {r:.2e}"
            if c is not None:
                line += f"  chip {c:.6f}  |diff|/|jax| {cr:.2e}"
            if p is not None:
                line += f"  jax x(1+{args.perturb:g}) {p:.6f}  |diff|/|jax| {abs(p - b) / abs(b):.2e}"
            print(line)
        record["variants"][variant] = {"timesteps": t_steps, "port": port, "jax": ref, "rel_diff": rel,
                                       "chip": on_chip, "chip_rel_diff": chip_rel, "jax_perturbed": nudged,
                                       "port_s": port_s, "jax_s": jax_s}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)


if __name__ == "__main__":
    main()
