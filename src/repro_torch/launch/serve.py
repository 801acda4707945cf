"""Serving launcher: the streaming aggregation service over a simulated
fleet — ``repro/launch/serve.py`` counterpart.

Stands up :class:`repro_torch.serve.AggregationService` around a model's
parameters (the reduced config of ``--config``, as the reference serves)
and drives it with synthetic fleet traffic: machine updates stream in,
optionally Byzantine-corrupted through the ``repro_torch.attacks``
registry and thinned by a straggler dropout rate, the ring buffer absorbs
them with in-place writes, and every round flushes into one model update.
On the card the order-statistics rules launch the CUDA kernel once per
parameter leaf per round; ``launches`` in the last line counts them.

  python -m repro_torch.launch.serve --config glm4-9b --machines 64 \\
      --rounds 5 --agg dcq_mad --eps 1.0 --byzantine 0.25 \\
      --attack signflip --dropout 0.3 --ingest-block 8

Runs on the CUDA card unless ``--device`` says otherwise; without a card
and without ``--device cpu`` it exits 1; an unknown architecture exits 2.
``--sharded`` splits the ring buffer's capacity axis (``--machines``)
over the ranks of a ``torch.distributed`` world, one device each
(``torchrun``; one process is a world of 1): every rank draws the same
fleet traffic and ingests its own slots, each flush gathers the buffer
leaf by leaf, and only rank 0 prints. The default ``--config`` is
``xlstm-125m``, as in the reference; every id of
``repro_torch.configs.ARCHS`` runs (the reference's ten).

Random streams (``repro_torch.core.keys``): the parameters come from the
``params`` stream, round r's fleet traffic from ``data`` index r, and the
service's noise from ``serve`` index r.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import resolve_device
from repro_torch.agg import has_masked, kernel
from repro_torch.agg import registered as registered_aggregators
from repro_torch.attacks import ALIASES as ATTACK_ALIASES
from repro_torch.attacks import registered as registered_attacks
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.keys import stream_generator
from repro_torch.core.transport import tree_leaves, tree_map, wire_corrupt
from repro_torch.launch.cli import add_common_flags, rank0, sharded_run
from repro_torch.models.model import Model
from repro_torch.serve import AggregationService, FlushPolicy, ServeConfig


def build_parser() -> argparse.ArgumentParser:
    """The serving CLI (shared flags from ``launch/cli.py``, ``--agg`` and
    ``--attack`` from the registries)."""
    ap = add_common_flags(argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve"))
    ap.add_argument("--machines", type=int, default=64,
                    help="fleet size per round (ring-buffer capacity)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--agg", default="dcq_mad",
                    choices=sorted(n for n in registered_aggregators()
                                   if has_masked(n)),
                    help="robust aggregator (repro_torch.agg registry, "
                    "masked partial-fill form required for serving)")
    ap.add_argument("--eps", type=float, default=0.0,
                    help="per-round DP budget; > 0 adds per-leaf "
                    "calibrated noise at every flush")
    ap.add_argument("--delta", type=float, default=1e-6)
    ap.add_argument("--byzantine", type=float, default=0.0,
                    help="fraction of the fleet sending corrupted updates")
    ap.add_argument("--attack", default="scale",
                    choices=sorted(set(registered_attacks())
                                   | set(ATTACK_ALIASES)))
    ap.add_argument("--attack-factor", type=float, default=-3.0)
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="straggler fraction: each round this share of "
                    "the fleet never arrives and the round flushes "
                    "partial")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--ingest-block", type=int, default=64,
                    help="bulk-ingest chunk (one block write per chunk)")
    ap.add_argument("--min-fill", type=int, default=1)
    return ap


def fleet_round(generator: torch.Generator, params, m: int, byz_mask,
                attack: str, factor: float):
    """One round of synthetic fleet traffic drawn from ``generator`` (on
    the parameters' device): per leaf a shared drift plus 0.3 x unit noise
    per machine, ``(m, *leaf)`` in the leaf's dtype, Byzantine rows
    corrupted on the wire."""
    def leaf(x):
        drift = torch.randn(x.shape, generator=generator, dtype=x.dtype,
                            device=x.device)
        ups = torch.randn((m,) + tuple(x.shape), generator=generator,
                          dtype=x.dtype, device=x.device)
        return ups.mul_(0.3).add_(drift)
    return wire_corrupt(generator, tree_map(leaf, params), byz_mask,
                        attack=attack, factor=factor)


def _refuse(code: int, msg: str):
    print(f"error: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv=None):
    """Run the launcher; returns the service. Exits 2 for an unknown arch
    and 1 when the device is not there."""
    args = build_parser().parse_args(argv)
    if args.arch not in ARCHS:
        _refuse(2, f"unknown arch {args.arch!r}; the configs are {ARCHS}")
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        _refuse(1, str(err))
    with sharded_run(args.machines, device, args.sharded) as mesh:
        return _serve(args, device, mesh)


def _serve(args, device, mesh):
    say = print if rank0() else (lambda *_a, **_k: None)
    cfg = get_config(args.arch, reduced=True)
    model = Model(cfg, device=device,
                  generator=stream_generator(args.seed, "params",
                                             device=device))
    # the reference's tree (the layer stack on a leading L axis), so every
    # leaf is noised at the reference's per-leaf sigma; detached views of
    # the parameters, updated in place by the service
    params = tree_map(torch.Tensor.detach, model.params())
    n_params = sum(x.numel() for x in tree_leaves(params))
    if mesh is not None:
        say(f"[serve] ring buffer sharded over {mesh.size()} device(s)")

    scfg = ServeConfig(method=args.agg, capacity=args.machines,
                       lr=args.lr, eps=args.eps, delta=args.delta,
                       ingest_block=min(args.ingest_block, args.machines),
                       seed=args.seed, accountant=args.accountant)
    policy = FlushPolicy(min_fill=args.min_fill)
    svc = AggregationService(params, scfg, policy=policy, device=device,
                             sharding=mesh)
    say(f"[serve] {cfg.name}: {n_params/1e6:.1f}M params, fleet "
        f"m={args.machines}, agg={args.agg} eps={args.eps} "
        f"byz={args.byzantine} dropout={args.dropout} on {device}")

    n_byz = int(args.byzantine * args.machines)
    byz_mask = (torch.arange(args.machines, device=device) < n_byz) \
        if n_byz else None
    attack = args.attack if n_byz else "none"

    launches0 = kernel.launches
    t0 = time.perf_counter()
    for r in range(args.rounds):
        gen = stream_generator(args.seed, "data", r, device)
        updates = fleet_round(gen, params, args.machines, byz_mask, attack,
                              args.attack_factor)
        if args.dropout > 0:
            arrive = max(args.min_fill,
                         args.machines - int(args.dropout * args.machines))
            updates = tree_map(lambda x: x[:arrive], updates)
        svc.submit_many(updates)
        if svc.fill:             # stragglers: a deadline-style partial flush
            svc.flush()
        h = svc.history[-1]
        say(f"  round {h['round']:3d} fill {h['fill']:5d}/"
            f"{args.machines} latency {h['latency_s']*1e3:7.2f} ms")
    dt = time.perf_counter() - t0

    served = sum(h["fill"] for h in svc.history)
    steady = [h["flush_s"] for h in svc.history[1:]] or \
        [svc.history[-1]["flush_s"]]
    say(f"[serve] {svc.round_idx} rounds, {served} updates in "
        f"{dt:.2f}s; steady flush {min(steady)*1e3:.2f} ms; "
        f"launches {kernel.launches - launches0} "
        f"({len(tree_leaves(params))} leaves)")
    if args.eps > 0:
        say(svc.accountant.summary())
    return svc


if __name__ == "__main__":
    main()
