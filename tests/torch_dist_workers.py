"""The ranks of tests/test_torch_dist_ranks.py: one process per rank of a
gloo group on the CPU, started by ``torch.multiprocessing`` with the
"spawn" method, so this module imports torch and the port only (no jax).

``run_world(rank, world, store, inputs, out)`` joins the group through a
``FileStore`` at ``store``, reads the parent's pickled inputs (data, the
reference's draws and DCQ knots), runs every case of its world through
the port's sharded paths and, on rank 0, through the unsharded ones too,
and pickles what it got to ``out/rank{rank}.pkl``.
"""
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

#: flat cases: name -> (machine rows m + 1, noiseless, attack, factor,
#: Byzantine machine 0); the reference runs them at world 3 (9 rows) and
#: world 4 (8 rows), the port at worlds 1 and 3, and 2 and 4
FLAT_CASES = {
    "9-noiseless": (9, True, "scale", -3.0, False),
    "9-noised-scale": (9, False, "scale", -3.0, True),
    "9-alie": (9, False, "alie", 1.5, True),
    "8-noiseless-scale": (8, True, "scale", -3.0, True),
    "8-noised": (8, False, "scale", -3.0, False),
    "8-ipm": (8, False, "ipm", 1.5, True),
}
PORT_WORLDS = {9: (1, 3), 8: (2, 4)}
#: the tree engine: the two-leaf least squares of tests/test_torch_qn.py
#: at m = 4 machines, two steps, world 2
TREE_M, TREE_N, TREE_STEPS, TREE_WORLD = 4, 40, 2, 2
TREE_CFG = dict(hist=4, lr=0.5, eps=50.0)
#: the service across ranks: capacity (divisible by worlds 1, 2 and 3),
#: the arrivals of each round (a full ring, a wrap past capacity, a
#: partial fill), the worlds it runs at, its config and flush policy (no
#: capacity trigger, overwrite at capacity: every round flushes by hand)
SERVE_C, SERVE_ARRIVALS, SERVE_WORLDS = 6, (6, 8, 5), (1, 2)
SERVE_CFG = dict(method="dcq_mad", capacity=SERVE_C, eps=0.5, lr=0.5,
                 seed=4, ingest_block=2)
SERVE_POLICY = dict(capacity_frac=None, backpressure="overwrite")


def two_leaf_grad(t, b):
    """Least squares with a weight and a bias, for jnp and torch alike."""
    Xb, yb = b
    r = Xb @ t["w"] + t["b"] - yb
    return 0.5 * (r ** 2).mean(), {"w": Xb.T @ r / Xb.shape[0],
                                   "b": r.mean().reshape(1)}


def _np(x):
    return x.detach().cpu().numpy().copy()


def _tree_out(out):
    from repro_torch.core import transport
    return {f: [_np(x) for x in transport.tree_leaves(getattr(out, f))]
            for f in ("theta_cq", "theta_os", "theta_qn", "v_s", "v_y",
                      "losses", "grad_norm")}


def _flat(inp, world, mesh, rank0):
    from repro_torch.core.losses import get_problem
    from repro_torch.core.protocol import DPQNProtocol
    from repro_torch.dist.sharded_protocol import run_sharded
    from repro_torch.interop import config_from_reference
    out = {}
    for name, (rows, noiseless, attack, factor, byz) in FLAT_CASES.items():
        if world not in PORT_WORLDS[rows]:
            continue
        X, y = (torch.from_numpy(a) for a in inp["data"][rows])
        cfg = config_from_reference(dict(eps=30.0, delta=0.05,
                                          noiseless=noiseless))
        mask = torch.arange(rows - 1) < 1 if byz else None
        noise = None if noiseless else {
            k: torch.from_numpy(v) for k, v in inp["noise"][name].items()}
        kw = dict(byz_mask=mask, attack=attack, attack_factor=factor,
                  noise=noise)
        res = run_sharded(get_problem("logistic"), cfg, mesh, X, y, **kw)
        got = {f: _np(res[f]) for f in ("theta_cq", "theta_os", "theta_qn")}
        if rank0:
            one = DPQNProtocol(get_problem("logistic"), cfg,
                               device="cpu").run(X, y, **kw)
            got["unsharded"] = {f: _np(getattr(one, f))
                                for f in ("theta_cq", "theta_os",
                                          "theta_qn")}
        out[name] = got
    return out


def _tree(inp, mesh, rank0):
    from repro_torch.core.protocol import protocol_tree_rounds
    from repro_torch.dist.collectives import gather_machines
    from repro_torch.dist.sharded_protocol import run_sharded_tree
    from repro_torch.interop import (tree_config_from_reference,
                                     tree_draws_from_numpy)
    cfg = tree_config_from_reference(TREE_CFG)
    X, y = (torch.from_numpy(a) for a in inp["tree_data"])
    mask = torch.arange(TREE_M) < 1
    states = {"sharded": ({"w": torch.zeros(3), "b": torch.zeros(1)}, None)}
    if rank0:
        states["unsharded"] = states["sharded"]
    steps = {k: [] for k in states}
    for noise in inp["tree_noise"]:
        draws = tree_draws_from_numpy(noise, "cpu")
        for kind, (theta, mem) in states.items():
            kw = dict(mem=mem, byz_mask=mask, attack="signflip", n=TREE_N,
                      noise=draws)
            out = run_sharded_tree(None, theta, (X, y), two_leaf_grad, cfg,
                                   mesh, **kw) if kind == "sharded" else \
                protocol_tree_rounds(None, theta, (X, y), two_leaf_grad,
                                     cfg, **kw)
            rec = _tree_out(out)
            local = out.mem
            if kind == "sharded":
                rec["local_machines"] = int(local.count.shape[0])
                local = type(local)(*(
                    {k: gather_machines(v, mesh) for k, v in h.items()}
                    for h in (local.s_hist, local.y_hist)),
                    gather_machines(local.count, mesh))
            rec["mem"] = {h: {k: _np(v) for k, v in getattr(local,
                                                            h).items()}
                          for h in ("s_hist", "y_hist")}
            rec["count"] = _np(local.count)
            steps[kind].append(rec)
            states[kind] = (out.theta_qn, out.mem)
    return steps


def _refusals(inp, mesh):
    """An axis that does not divide over the ranks, in both engines."""
    from repro_torch.core.losses import get_problem
    from repro_torch.dist.sharded_protocol import run_sharded, \
        run_sharded_tree
    from repro_torch.interop import (config_from_reference,
                                     tree_config_from_reference)
    msgs = []
    X, y = (torch.from_numpy(a) for a in inp["data"][8])
    try:
        run_sharded(get_problem("logistic"), config_from_reference(
            dict(noiseless=True)), mesh, X, y)
    except ValueError as err:
        msgs.append(str(err))
    X, y = (torch.from_numpy(a) for a in inp["tree_data"])
    try:
        run_sharded_tree(None, {"w": torch.zeros(3), "b": torch.zeros(1)},
                         (X, y), two_leaf_grad,
                         tree_config_from_reference(dict(eps=0.0)), mesh)
    except ValueError as err:
        msgs.append(str(err))
    return msgs


def _service(inp, sharding, **cfg):
    from repro_torch.interop import tree_from_numpy
    from repro_torch.serve import AggregationService, FlushPolicy, ServeConfig
    return AggregationService(
        tree_from_numpy(inp["serve"]["theta"], device="cpu"),
        ServeConfig(**{**SERVE_CFG, **cfg}),
        policy=FlushPolicy(**SERVE_POLICY), device="cpu", sharding=sharding)


def _serve(inp, mesh, rank0):
    """The service over ``mesh`` (and, on rank 0, unsharded) on the
    parent's updates and the reference's noise: every round's aggregate
    and theta, the fills, the ledger and the rows this rank holds."""
    from repro_torch.core.transport import tree_leaves
    from repro_torch.interop import serve_noise_from_numpy, tree_from_numpy
    out = {}
    for kind, sharding in (("sharded", mesh), ("unsharded", None)):
        if kind == "unsharded" and not rank0:
            continue
        svc = _service(inp, sharding)
        rounds = []
        for ups, noise in zip(inp["serve"]["updates"], inp["serve"]["noise"]):
            svc.submit_many(tree_from_numpy(ups, device="cpu"))
            red = svc.flush(noise=serve_noise_from_numpy(noise, svc.theta,
                                                         device="cpu"))
            rounds.append({"agg": [_np(x) for x in tree_leaves(red)],
                           "theta": [_np(x)
                                     for x in tree_leaves(svc.theta)]})
        out[kind] = {"rounds": rounds, "ledger": svc.ledger,
                     "fills": [h["fill"] for h in svc.history],
                     "rows": tree_leaves(svc.buffer.arrays)[0].shape[0]}
    return out


def _serve_refusals(inp, mesh, rank):
    """A capacity that does not divide over the ranks, and ranks whose
    fills differ (rank r handed 3 + r arrivals, against the contract)."""
    from repro_torch.interop import tree_from_numpy
    msgs = []
    try:
        _service(inp, mesh, capacity=5)
    except ValueError as err:
        msgs.append(str(err))
    svc = _service(inp, mesh)
    ups = tree_from_numpy(inp["serve"]["updates"][0], device="cpu")
    svc.submit_many({k: v[:3 + rank] for k, v in ups.items()})
    try:
        svc.flush()
    except ValueError as err:
        msgs.append(str(err))
    return msgs


def run_world(rank, world, store, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.agg import reference as tagg_ref
        from repro_torch.dist.collectives import sharded_aggregate_leaf
        from repro_torch.dist.grad_agg import GradAggConfig
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        knots = inp["knots"]
        # the reference's float32 DCQ knots (2-3 ulp from the port's)
        tagg_ref.quantile_knots = lambda K, device=None: torch.tensor(
            knots, device=device)
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("machines",))
        got = {"flat": _flat(inp, world, mesh, rank == 0)}
        if world in (2, 4):
            g = torch.from_numpy(inp["leaf"])
            k = g.shape[0] // world
            got["leaf"] = _np(sharded_aggregate_leaf(
                g[rank * k:(rank + 1) * k], GradAggConfig(method="dcq"),
                mesh, ("machines", None, None)))
        if world == TREE_WORLD:
            got["tree"] = _tree(inp, mesh, rank == 0)
        if world == 3:
            got["refusals"] = _refusals(inp, mesh)
        if world in SERVE_WORLDS:
            got["serve"] = _serve(inp, mesh, rank == 0)
        if world == 2:
            got["serve_refusals"] = _serve_refusals(inp, mesh, rank)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()
