"""Training launcher: robust-DP training of a model-zoo ``--config`` —
``repro/launch/train.py`` counterpart.

The reduced config of ``--config`` (``--full`` for the full one) trains
on synthetic Markov LM batches by one of two optimizer paths:

  * ``--optimizer adamw`` (default): per-machine gradients -> attack -> DP
    noise -> robust aggregation -> AdamW (``repro_torch.train.Trainer``);
    on the card one launch of the CUDA kernel B1 per parameter leaf and
    step;
  * ``--optimizer qn``: every step is one run of the paper's Algorithm 1
    over the parameter tree (``repro_torch.train.QNTrainer``): five DP
    transmissions, per-leaf calibrated noise, per-machine L-BFGS
    curvature (``--hist``); on the card five B1 launches per leaf and
    step.

The step lines print the B1 launches beside the loss.

  python -m repro_torch.launch.train --config glm4-9b --steps 12 \\
      --machines 4 --agg dcq --byzantine 0.25 --attack scale
  python -m repro_torch.launch.train --config glm4-9b --optimizer qn \\
      --machines 4 --byzantine 0.25 --attack signflip

Runs on the CUDA card unless ``--device`` says otherwise; without a card
and without ``--device cpu`` it exits 1, and an unknown architecture
exits 2. The default ``--config`` is ``xlstm-125m``, as in the reference;
every id of ``repro_torch.configs.ARCHS`` runs (the reference's ten).

``--sharded`` spreads the machines over the ranks of a
``torch.distributed`` world (``launch.cli.machine_mesh``), one device a
rank: each rank computes its own machines' gradients and keeps their
L-BFGS memory, and every rank ends each step with the same parameters.
Rank 0 prints and writes the checkpoint (the QN memory gathered first).
On the CPU, two ranks:

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
      --config glm4-9b --machines 4 --sharded --device cpu

Random streams (``repro_torch.core.keys``): the parameters come from the
``params`` stream, the batches from ``batches`` and the wire's draws from
``protocol``, as the reference names its keys.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.agg import kernel
from repro_torch.agg import registered as registered_aggregators
from repro_torch.attacks import ALIASES as ATTACK_ALIASES
from repro_torch.attacks import registered as registered_attacks
from repro_torch.checkpoint import checkpoint
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import TreeProtocolConfig
from repro_torch.core.dp import TREE_TRANSMISSIONS
from repro_torch.core.keys import stream_generator
from repro_torch.core.transport import tree_leaves
from repro_torch.data.lm import synthetic_lm_batches
from repro_torch.dist.grad_agg import GradAggConfig
from repro_torch.launch.cli import add_common_flags, rank0, sharded_run
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.trainer import (QNTrainConfig, QNTrainer,
                                       TrainConfig, Trainer)


def build_parser() -> argparse.ArgumentParser:
    """The reference's training CLI (shared flags from ``launch/cli.py``,
    ``--agg`` and ``--attack`` from the registries)."""
    ap = add_common_flags(argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train"))
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--machines", type=int, default=4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "qn"],
                    help="adamw: robust-aggregated data parallel; qn: the "
                    "paper's five-transmission quasi-Newton protocol as the "
                    "train step")
    ap.add_argument("--agg", default="dcq",
                    choices=sorted(registered_aggregators()),
                    help="robust aggregator (repro_torch.agg registry); "
                    "\"dcq\" means the MAD-self-calibrated \"dcq_mad\": the "
                    "training wire carries no variance estimates")
    ap.add_argument("--dp-sigma", type=float, default=0.0)
    ap.add_argument("--eps", type=float, default=0.0,
                    help="per-step DP budget; > 0 turns on per-leaf "
                    "calibrated noise (eps/5 per transmission on the qn "
                    "path, mean-mechanism sigma on the adamw path)")
    ap.add_argument("--byzantine", type=float, default=0.0)
    ap.add_argument("--attack", default="scale",
                    choices=sorted(set(registered_attacks())
                                   | set(ATTACK_ALIASES)))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--hist", type=int, default=5,
                    help="L-BFGS memory length (qn path)")
    ap.add_argument("--ckpt", default="")
    return ap


def _refuse(code: int, msg: str):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv=None):
    """Run the launcher; returns the per-step losses. Exits 2 for an
    unknown arch and 1 when the device is not there."""
    args = build_parser().parse_args(argv)
    if args.arch not in ARCHS:
        _refuse(2, f"unknown arch {args.arch!r}; the configs are {ARCHS}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        _refuse(1, str(err))
    with sharded_run(args.machines, device, args.sharded) as mesh:
        return _train(args, device, mesh)


def _train(args, device, mesh):
    say = print if rank0() else (lambda *a, **k: None)

    cfg = get_config(args.arch, reduced=args.reduced)
    model = Model(cfg, device=device, remat=True,
                  generator=stream_generator(args.seed, "params",
                                             device=device))
    params = model.params()
    n_params = sum(x.numel() for x in tree_leaves(params))
    say(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}): "
          f"{n_params/1e6:.1f}M params, {args.machines} machines, "
          f"opt={args.optimizer} agg={args.agg} sigma={args.dp_sigma} "
          f"eps={args.eps} byz={args.byzantine} on {device}"
          + (f", {mesh.size()} rank(s)" if mesh is not None else ""))

    attack = args.attack if args.byzantine > 0 else "none"
    if args.optimizer == "qn":
        # the qn wire transmits no variance estimates, so oracle-scale
        # "dcq" maps to its MAD-self-calibrated variant (grad_agg does
        # the same mapping on the adamw path)
        agg = "dcq_mad" if args.agg == "dcq" else args.agg
        qcfg = QNTrainConfig(
            n_machines=args.machines, attack=attack,
            protocol=TreeProtocolConfig(hist=args.hist, lr=args.lr,
                                        eps=args.eps, aggregator=agg,
                                        accountant=args.accountant))
        trainer = QNTrainer(model, qcfg, mesh)
        what = (f"{len(TREE_TRANSMISSIONS)} transmissions x "
                f"{len(tree_leaves(params))} leaves")
    else:
        tcfg = TrainConfig(
            n_machines=args.machines, remat=True,
            agg=GradAggConfig(method=args.agg, dp_sigma=args.dp_sigma,
                              attack=attack, dp_eps=args.eps,
                              dp_n=args.batch // args.machines))
        trainer = Trainer(model, AdamW(lr=args.lr), tcfg, mesh)
        what = f"{len(tree_leaves(params))} leaves"

    n_byz = int(args.byzantine * args.machines)
    byz_mask = (torch.arange(args.machines, device=device) < n_byz) \
        if n_byz else None
    batches = synthetic_lm_batches(
        stream_generator(args.seed, "batches", device=device), cfg,
        args.steps, args.batch, args.seq)

    t0 = time.time()
    losses = []
    launches0 = [kernel.launches]

    def cb(i, metrics):
        losses.append(float(metrics["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            say(f"  step {i:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"launches {kernel.launches - launches0[0]} "
                  f"({time.time()-t0:.1f}s)")

    params, opt_state, _ = trainer.fit(
        params, batches, stream_generator(args.seed, "protocol",
                                          device=device),
        byz_mask=byz_mask, callback=cb)
    say(f"[train] done: first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f} in {time.time()-t0:.1f}s; B1 launches "
          f"{kernel.launches - launches0[0]} ({what} x {len(losses)} "
          f"steps)")
    if args.optimizer == "adamw" and trainer.ledger["per_step"]:
        say(f"[train] DP ledger: {len(trainer.ledger['per_step'])} leaf "
              f"records per step, total eps "
              f"{trainer.ledger['total_eps']}")
    if args.ckpt:
        if mesh is not None and args.optimizer == "qn":
            # every rank holds its machines' memory: gather it first
            opt_state = _gather_memory(opt_state, mesh)
        if rank0():
            checkpoint.save(args.ckpt, params, opt_state, step=args.steps,
                            meta={"arch": args.arch, "agg": args.agg,
                                  "optimizer": args.optimizer})
        say(f"[train] checkpoint -> {args.ckpt}")
    return losses


def _gather_memory(mem, mesh):
    """The whole per-machine L-BFGS memory from every rank's part (a
    collective)."""
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.transport import tree_map
    from repro_torch.dist.collectives import gather_machines

    def gather(x):
        return gather_machines(x, mesh)
    return LBFGSMemory(tree_map(gather, mem.s_hist),
                       tree_map(gather, mem.y_hist), gather(mem.count))


if __name__ == "__main__":
    main()
