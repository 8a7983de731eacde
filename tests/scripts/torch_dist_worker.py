"""One rank of the port's distribution layer on gloo, for
``tests/test_torch_parallel.py``.

    python torch_dist_worker.py RANK WORLD PORT INPUTS.npz OUT_DIR

Joins a ``WORLD``-process gloo group on ``127.0.0.1:PORT``, builds the
``DistGraph`` from the edge list in ``INPUTS.npz`` and runs every case on
this rank's shard, on the CPU: ``dist_spmm`` (both routes, overlap on and
off, unweighted, weighted, two heads), ``dist_gat_attention``, the three
layers and the distributed GCN training step of
``benchmarking/dist/train.py`` (loss, gradients after
``reduce_replicated_grads`` and the parameters after one Adam step); then
the distributed dynamic graph (``partition_dynamic`` of WORLD shards, a
replay of the staged deltas with ``dist_dyn_apply_delta``, and at each step
``dist_dyn_spmm`` and ``dist_dyn_degree``, with the features' gradient of
the steps' summed products), unweighted and weighted; and the batched TGCN
loss of ``parallel.batch`` with its gradients on the 2-D meshes of WORLD
ranks (1 x 2 and 2 x 1 for two ranks, 2 x 2 for four), and its
``ValueError``s for a batch that does not divide. Writes
``OUT_DIR/rank{RANK}.npz``: node arrays as this rank's Ns rows, parameter
gradients whole.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..")))

from stgraph_tpu_torch.convert import (  # noqa: E402
    dist_gat_params_from_jax,
    dist_gcn_params_from_jax,
    dist_tgcn_params_from_jax,
)
from stgraph_tpu_torch.graph.delta_graph import EdgeStore  # noqa: E402
from stgraph_tpu_torch.parallel import (  # noqa: E402
    dist_dyn_apply_delta,
    dist_dyn_degree,
    dist_dyn_spmm,
    dist_gat_attention,
    dist_gat_conv,
    dist_gcn_conv,
    dist_spmm,
    dist_tgcn_cell,
    dist_tgcn_batched_loss,
    launch,
    make_mesh,
    partition_dynamic,
    partition_edges,
    reduce_replicated_grads,
    replicate,
    shard_dyn_arrays,
    shard_edge_array,
    shard_node_array,
    shard_window_batch,
)
from stgraph_tpu_torch.parallel.halo import exchange  # noqa: E402


def _params(inp, prefix):
    """The nested numpy dict stored flat as ``prefix/a/b``."""
    tree = {}
    for key in inp.files:
        if key.startswith(prefix + "/"):
            node = tree
            parts = key[len(prefix) + 1 :].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = inp[key]
    return tree


def main():
    rank, world, port, inputs, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    launch.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo")
    mesh = make_mesh(device="cpu")
    inp = np.load(inputs)
    n = int(inp["n"])
    dg = partition_edges(inp["src"], inp["dst"], n, world)
    out = {}

    def node(name):
        return shard_node_array(mesh, torch.from_numpy(inp[name]), dg)

    # dist_spmm, unweighted: both routes, overlap on and off
    h, g_out = node("spmm_h"), node("spmm_g")
    for impl in ("torch", "kernel"):
        for overlap in (True, False):
            hh = h.clone().requires_grad_(True)
            y = dist_spmm(mesh, dg, hh, overlap=overlap, impl=impl)
            (gh,) = torch.autograd.grad((y * g_out).sum(), [hh])
            out[f"spmm/{impl}/{int(overlap)}/out"] = y.detach().numpy()
            out[f"spmm/{impl}/{int(overlap)}/dh"] = gh.numpy()

    # weighted, one head and two heads (local-order weights)
    for case, hname, wname in (("w1", "w1_h", "w1_w"), ("wh", "wh_h", "wh_w")):
        hx, gx = node(hname), node(case + "_g")
        wl = shard_edge_array(mesh, torch.from_numpy(inp[wname]), dg, "local")
        for impl, overlap in (("torch", True), ("kernel", True), ("kernel", False)):
            hh, ww = hx.clone().requires_grad_(True), wl.clone().requires_grad_(True)
            y = dist_spmm(mesh, dg, hh, edge_weight=ww, overlap=overlap, impl=impl)
            gh, gw = torch.autograd.grad((y * gx).sum(), [hh, ww])
            key = f"{case}/{impl}/{int(overlap)}"
            out[key + "/out"], out[key + "/dh"], out[key + "/dw"] = y.detach().numpy(), gh.numpy(), gw.numpy()

    # GAT attention
    el, er, fs, gg = node("gat_el"), node("gat_er"), node("gat_fs"), node("gat_g")
    for impl in ("torch", "kernel"):
        a, b, c = (t.clone().requires_grad_(True) for t in (el, er, fs))
        y = dist_gat_attention(mesh, dg, a, b, c, impl=impl)
        grads = torch.autograd.grad((y * gg).sum(), [a, b, c])
        out[f"gat/{impl}/out"] = y.detach().numpy()
        for name, gr in zip(("del", "der", "dfs"), grads):
            out[f"gat/{impl}/{name}"] = gr.numpy()

    # layers, parameters from the JAX package's dicts, replicated from rank 0
    def layer_case(name, convert, run, inputs_):
        for impl in ("torch", "kernel"):
            params = replicate(mesh, convert(_params(inp, name + "_params"), device="cpu"))

            def req(tree):
                for v in tree.values():
                    if isinstance(v, dict):
                        req(v)
                    else:
                        v.requires_grad_(True)

            req(params)
            xs = [node(nm) for nm in inputs_]
            xs[0].requires_grad_(True)
            y = run(params, xs, impl)
            (y * node(name + "_g")).sum().backward()
            reduce_replicated_grads(mesh, params)
            out[f"{name}/{impl}/out"] = y.detach().numpy()
            out[f"{name}/{impl}/dx"] = xs[0].grad.numpy()
            _save_grads(out, f"{name}/{impl}/grad", params)

    layer_case("gcn", dist_gcn_params_from_jax,
               lambda p, xs, impl: dist_gcn_conv(mesh, dg, p, xs[0], xs[1], activation=torch.relu, impl=impl),
               ["gcn_x", "norm"])
    layer_case("tgcn", dist_tgcn_params_from_jax,
               lambda p, xs, impl: dist_tgcn_cell(mesh, dg, p, xs[0], xs[1], xs[2], impl=impl),
               ["tgcn_x", "norm", "tgcn_hid"])
    layer_case("gatc", dist_gat_params_from_jax,
               lambda p, xs, impl: dist_gat_conv(mesh, dg, p, xs[0], activation=torch.nn.functional.elu, impl=impl),
               ["gatc_x"])

    # benchmarking/dist/train.py's step: 3 GCN layers, CE mean over the P*Ns
    # padded rows (labels padded with 0), Adam 1e-2
    x, norm = node("train_x"), node("norm")
    labels = node("train_y").long()
    layers = int(inp["train_layers"])
    for impl in ("torch", "kernel"):
        params = {k: torch.from_numpy(inp[f"train_params/{k}"]).clone().requires_grad_(True)
                  for k in (f"{t}{i}" for i in range(layers) for t in "wb")}
        hcur = x
        for i in range(layers):
            hcur = (hcur @ params[f"w{i}"] + params[f"b{i}"]) * norm
            hcur = dist_spmm(mesh, dg, hcur, impl=impl) * norm
            if i < layers - 1:
                hcur = torch.relu(hcur)
        loss = torch.nn.functional.cross_entropy(hcur, labels, reduction="sum") / dg.padded_nodes
        loss.backward()
        reduce_replicated_grads(mesh, params)
        total = loss.detach().clone()
        torch.distributed.all_reduce(total, group=mesh.get_group("graph"))
        out[f"train/{impl}/loss"] = total.numpy()
        for k, v in params.items():
            out[f"train/{impl}/grad/{k}"] = v.grad.numpy()
        opt = torch.optim.Adam(params.values(), lr=1e-2)
        opt.step()
        for k, v in params.items():
            out[f"train/{impl}/after/{k}"] = v.detach().numpy()

    out["exchange_rows"] = np.int64(exchange.rows)  # the cases above; the ones below exchange too
    dyn_cases(inp, mesh, world, out)
    batch_cases(inp, world, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    launch.shutdown()
    print(f"[rank {rank}] TORCH DIST OK", flush=True)


def dyn_cases(inp, mesh, world, out):
    """``parallel.dyn`` on this rank's shard: the carry after each step, and
    each step's output and degrees; the features' gradient of the sum over
    the steps of ``(out_t * g_t).sum()``."""
    n = int(inp["n"])
    for case in ("u", "w"):
        weighted = case == "w"
        init = EdgeStore(inp["dyn_rows0"], inp["dyn_cols0"], inp["dyn_ne0"], n,
                         inp["dyn_w0"] if weighted else None)
        ddg = partition_dynamic(init, inp["dyn_add"], inp["dyn_del"], inp["dyn_add_w"] if weighted else None, world)
        (rows, cols, w, ne), (adds, dels, add_w) = shard_dyn_arrays(mesh, ddg)
        h = shard_node_array(mesh, torch.from_numpy(inp["dyn_h"]), ddg).requires_grad_(True)
        total = 0.0
        for t in range(adds.shape[0]):
            rows, cols, w, ne = dist_dyn_apply_delta(mesh, ddg, rows, cols, w, ne, adds[t], dels[t],
                                                     None if add_w is None else add_w[t])
            y = dist_dyn_spmm(mesh, ddg, rows, cols, w, h)
            g = shard_node_array(mesh, torch.from_numpy(inp["dyn_g"][t]), ddg)
            total = total + (y * g).sum()
            key = f"dyn/{case}/{t}"
            out[key + "/rows"], out[key + "/cols"], out[key + "/ne"] = rows.numpy(), cols.numpy(), ne.numpy()
            if weighted:
                out[key + "/w"] = w.numpy()
            out[key + "/out"] = y.detach().numpy()
            out[key + "/deg"] = dist_dyn_degree(mesh, ddg, rows).numpy()
        total.backward()
        out[f"dyn/{case}/dh"] = h.grad.numpy()


BATCH_MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}  # (data, graph)


def batch_cases(inp, world, out):
    """``dist_tgcn_batched_loss`` and its gradients on each 2-D mesh of the
    world; then a batch of 3 windows over 2 data ranks, refused by
    ``shard_window_batch`` and, sliced unevenly, by the loss."""
    n = int(inp["n"])
    for data, graph in BATCH_MESHES[world]:
        mesh = make_mesh(graph=graph, data=data, device="cpu")
        dg = partition_edges(inp["src"], inp["dst"], n, graph)
        params = dist_tgcn_params_from_jax(_params(inp, "tgcn_params"), device="cpu")
        for sub in params.values():
            for v in sub.values():
                v.requires_grad_(True)
        norm = shard_node_array(mesh, torch.from_numpy(inp["norm"]), dg)
        xs = shard_window_batch(mesh, inp["bt_x"], dg)
        ys = shard_window_batch(mesh, inp["bt_y"], dg)
        loss = dist_tgcn_batched_loss(mesh, dg, params, norm, xs, ys)
        loss.backward()
        out[f"batch/{data}x{graph}/loss"] = loss.detach().numpy()
        _save_grads(out, f"batch/{data}x{graph}/grad", params)
        if data == 2:
            refused = 0
            try:
                shard_window_batch(mesh, inp["bt_x"][:1].repeat(3, 0), dg)
            except ValueError:
                refused += 1
            uneven = xs[:1] if mesh.get_local_rank("data") == 0 else xs[:0]
            try:
                dist_tgcn_batched_loss(mesh, dg, params, norm, torch.cat([xs, uneven]), torch.cat([ys, ys[:len(uneven)]]))
            except ValueError:
                refused += 1
            out[f"batch/{data}x{graph}/refused"] = np.int64(refused)


def _save_grads(out, prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            _save_grads(out, f"{prefix}/{k}", v)
        else:
            out[f"{prefix}/{k}"] = v.grad.numpy()


if __name__ == "__main__":
    main()
