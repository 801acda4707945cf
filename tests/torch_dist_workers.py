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
#: payload sharding in world 4: the reduced glm4-9b (f32) on m = 4
#: machines of PAYLOAD_ROWS rows of PAYLOAD_SEQ tokens, machine 0
#: signflipped, PAYLOAD_STEPS steps of AdamW (dcq_mad, lr PAYLOAD_LR, the
#: default eps) and of the QN step (the median), noiseless against the
#: reference and the port's unsharded step, and at every sigma
#: PAYLOAD_SIGMA on the parent's whole-leaf draws against the port's
#: unsharded step; meshes (data 2, model 2) and, for AdamW, (pod 2, data
#: 1, model 2); one decode step of PAYLOAD_DECODE_B requests at (data 2,
#: model 2) from a cache of PAYLOAD_DECODE_POS filled slots
PAYLOAD_M, PAYLOAD_ROWS, PAYLOAD_SEQ, PAYLOAD_STEPS = 4, 8, 16, 2
PAYLOAD_LR, PAYLOAD_SIGMA = 1e-3, 1e-3
PAYLOAD_MESHES = {"data2-model2": ((2, 2), ("data", "model")),
                  "pod2-data1-model2": ((2, 1, 2), ("pod", "data", "model"))}
PAYLOAD_DECODE_B, PAYLOAD_DECODE_POS, PAYLOAD_DECODE_LEN = 4, 5, 16


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


def _held_bytes(tree):
    from repro_torch.core.transport import tree_leaves
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _payload(inp, meshes, rank0):
    """Both trainers with the payload dims over "model" (see
    PAYLOAD_MESHES), and on rank 0 the unsharded runs on the same inputs:
    every step's losses, grad norm and whole parameters (gathered), the
    bytes this rank holds against the whole tree's, the whole-tree norm
    and ``tree_dot`` under the payload, and the decode step. On rank 0,
    AdamW's every step also keeps the wire of each leaf: the ``(m,
    *leaf)`` rows the aggregation took (after the attack and the noise)
    and its aggregate, both whole (gathered over "model")."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.transport import tree_dot, tree_leaves
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.interop import (batch_from_numpy, params_from_reference,
                                     tree_draws_from_numpy, tree_from_numpy)
    from repro_torch.train.optimizer import AdamW, global_norm
    from repro_torch.train.trainer import (QNTrainConfig, QNTrainer,
                                           TrainConfig, make_train_step)
    pin = inp["payload"]
    cfg = get_config("glm4-9b", reduced=True)
    batches = [batch_from_numpy(b, "cpu") for b in pin["batches"]]
    mask = torch.arange(PAYLOAD_M) < 1

    def fresh():
        return params_from_reference(pin["params"], cfg, device="cpu")

    def adamw(mesh, noised):
        from repro_torch.dist import grad_agg
        model = fresh()
        agg = GradAggConfig(method="dcq_mad", attack="signflip",
                            dp_sigma=PAYLOAD_SIGMA if noised else 0.0)
        opt = AdamW(lr=PAYLOAD_LR)
        step = make_train_step(model, opt, TrainConfig(n_machines=PAYLOAD_M,
                                                       agg=agg), mesh)
        pl = step.payload
        params = model.params() if pl is None else pl.shard(model.params())
        state = opt.init(params)
        rec = {"loss": [], "grad_norm": [], "wire": []}
        aggregate, calls = grad_agg.aggregate_machine_axis, []

        def kept(values, cfg):
            out = aggregate(values, cfg)
            calls.append((values.clone(), out.clone()))
            return out
        grad_agg.aggregate_machine_axis = kept
        try:
            for i, batch in enumerate(batches):
                noise = tree_from_numpy(pin["adamw_noise"][i], "cpu") \
                    if noised else None
                calls.clear()
                params, state, met = step(params, state, batch, None, mask,
                                          noise=noise)
                rec["loss"].append(_np(met["loss"]))
                rec["grad_norm"].append(_np(met["grad_norm"]))
                wire = [(v, o) if pl is None or pl.dims[j] is None else
                        (pl.axis.all_gather(v, pl.dims[j]),
                         pl.axis.all_gather(o, pl.dims[j]))
                        for j, (v, o) in enumerate(calls)]
                if rank0:
                    rec["wire"].append([(_np(v), _np(o)) for v, o in wire])
        finally:
            grad_agg.aggregate_machine_axis = aggregate
        if pl is not None:
            rec["held"] = {"params": _held_bytes(params),
                           "moments": _held_bytes((state.mu, state.nu))}
            rec["shapes"] = [tuple(x.shape) for x in tree_leaves(params)]
            rec["moment_shapes"] = [tuple(x.shape)
                                    for x in tree_leaves(state.mu)]
            with pl.active():
                rec["norm_local"] = _np(global_norm(params))
                rec["dot_local"] = _np(tree_dot(params, state.mu))
            params = pl.unshard(params)
            state = type(state)(state.step, pl.unshard(state.mu),
                                pl.unshard(state.nu))
        rec["norm_whole"] = _np(global_norm(params))
        rec["dot_whole"] = _np(tree_dot(params, state.mu))
        rec["held_whole"] = {"params": _held_bytes(params),
                             "moments": _held_bytes((state.mu, state.nu))}
        rec["params"] = [_np(x) for x in tree_leaves(params)]
        return rec

    def qn(mesh, noised):
        model = fresh()
        pcfg = TreeProtocolConfig(aggregator="median", hist=2,
                                  eps=1.0 if noised else 0.0)
        trainer = QNTrainer(model, QNTrainConfig(
            n_machines=PAYLOAD_M, attack="signflip", protocol=pcfg), mesh)
        pl = trainer.payload
        params = model.params() if pl is None else pl.shard(model.params())
        mem = trainer.init_memory(params)
        rec = {"loss": [], "grad_norm": []}
        for i, batch in enumerate(batches):
            kw = {}
            if noised:
                kw = dict(sigmas={k: PAYLOAD_SIGMA
                                  for k in pin["qn_noise"][i]},
                          noise=tree_draws_from_numpy(pin["qn_noise"][i],
                                                      "cpu"))
            params, mem, met = trainer.step_fn(params, mem, batch, None,
                                               mask, **kw)
            rec["loss"].append(_np(met["loss"]))
            rec["grad_norm"].append(_np(met["grad_norm"]))
        if pl is not None:
            rec["held"] = {"params": _held_bytes(params),
                           "memory": _held_bytes((mem.s_hist, mem.y_hist))}
            rec["mem_shapes"] = [tuple(x.shape)
                                 for x in tree_leaves(mem.s_hist)]
            params = pl.unshard(params)
            mem = LBFGSMemory(pl.unshard(mem.s_hist),
                              pl.unshard(mem.y_hist), mem.count)
        rec["held_whole"] = {"params": _held_bytes(params),
                             "memory": _held_bytes((mem.s_hist,
                                                    mem.y_hist))}
        rec["params"] = [_np(x) for x in tree_leaves(params)]
        rec["y_hist"] = [_np(x) for x in tree_leaves(mem.y_hist)]
        return rec

    def decode(mesh):
        """One decode step of the whole batch: this rank's rows (the data
        rank's half, then the model rank's half of it), gathered back."""
        from repro_torch.dist.collectives import mesh_axis
        from repro_torch.dist.payload import payload_for
        model = fresh()
        pl = payload_for(model, mesh)
        B = PAYLOAD_DECODE_B
        g = torch.Generator().manual_seed(3)
        kv = torch.randn((2, cfg.n_layers, B, PAYLOAD_DECODE_LEN,
                          cfg.n_kv_heads, cfg.head_dim), generator=g)
        tok = torch.randint(0, cfg.vocab, (B, 1), generator=g)
        rows = slice(0, B)
        if mesh is not None:
            for name in ("data", "model"):
                ax = mesh_axis(mesh, name)
                n = (rows.stop - rows.start) // ax.size
                start = rows.start + ax.rank * n
                rows = slice(start, start + n)
        cache = model.init_cache(rows.stop - rows.start, PAYLOAD_DECODE_LEN)
        cache["attn"]["k"].copy_(kv[0][:, rows])
        cache["attn"]["v"].copy_(kv[1][:, rows])
        cache["pos"] = PAYLOAD_DECODE_POS
        params = model.params() if pl is None else pl.shard(model.params())
        if pl is None:
            logits, cache = model.decode_step(cache, {"tokens": tok[rows]},
                                              params=params)
        else:
            with pl.active():
                logits, cache = model.decode_step(
                    cache, {"tokens": tok[rows]}, params=params)
            for name in ("model", "data"):
                logits = mesh_axis(mesh, name).all_gather(logits, 0)
        return {"logits": _np(logits), "pos": cache["pos"]}

    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    for name, (shape, names) in PAYLOAD_MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        got = {"adamw": adamw(mesh, False)}
        if name == "data2-model2":
            got["adamw_noised"] = adamw(mesh, True)
            got["qn"] = qn(mesh, False)
            got["qn_noised"] = qn(mesh, True)
            got["decode"] = decode(mesh)
        out[name] = got
    if rank0:
        out["unsharded"] = {"adamw": adamw(None, False),
                            "adamw_noised": adamw(None, True),
                            "qn_noised": qn(None, True),
                            "decode": decode(None)}
    return out


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
        if world == 4:
            got["payload"] = _payload(inp, mesh, rank == 0)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()
