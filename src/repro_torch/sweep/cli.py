"""``python -m repro_torch.sweep`` — run a scenario sweep preset end to
end (``repro/sweep/cli.py`` counterpart).

Examples::

    python -m repro_torch.sweep --preset smoke
    python -m repro_torch.sweep --preset paper --out build/sweep_paper.json
    python -m repro_torch.sweep --preset fig-eps --list   # grid only
    python -m repro_torch.sweep --preset smoke --fast --device cpu
    python -m repro_torch.sweep --preset zoo-smoke --fast --device cpu

The sweep runs on the CUDA card unless ``--device`` says otherwise, and
refuses to start on a machine without one rather than carry on on the
CPU. ``--sharded`` spreads every scenario's machines over the ranks of a
``torch.distributed`` world, one device a rank (``torchrun``; one process
alone is a world of 1); rank 0 prints and writes the artifact::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.sweep \
        --preset smoke --fast --sharded --device cpu
 The artifact (versioned JSON, see ``sweep/artifact.py``) is written
after every group chunk; re-running the same command resumes from the
completed scenarios unless ``--no-resume``. ``--csv`` additionally emits
a flat per-scenario table.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from repro_torch import privacy, resolve_device
from repro_torch.launch.cli import rank0, sharded_run
from repro_torch.sweep import artifact as artifact_mod
from repro_torch.sweep.executor import SweepExecutor
from repro_torch.sweep.grid import group_label, group_scenarios
from repro_torch.sweep.presets import PRESETS, build_preset, fast_variant

def _default_out(preset: str) -> str:
    return f"build/sweep_{preset}.json"


def _summarize(art) -> str:
    lines = []
    header = (f"{'scenario':<58} {'metric':>10} {'value':>9}")
    lines.append(header)
    lines.append("-" * len(header))
    for sid, rec in art["scenarios"].items():
        for name, val in sorted(rec["metrics"].items()):
            if isinstance(val, (int, float)):   # not a training loss curve
                lines.append(f"{sid:<58} {name:>10} {val:9.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep",
        description="Scenario-sweep engine over the paper's §5 grid "
                    "(losses x attacks x aggregators x eps x m x alpha), "
                    "on the CUDA card.")
    ap.add_argument("--preset", default="smoke",
                    choices=sorted(PRESETS),
                    help="scenario grid to run (default: smoke)")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: build/"
                         "sweep_<preset>.json)")
    ap.add_argument("--csv", default=None,
                    help="also write a flat CSV of per-scenario rows")
    ap.add_argument("--fast", action="store_true",
                    help="reduced replicate counts (a smoke of big grids)")
    ap.add_argument("--no-resume", action="store_true",
                    help="ignore any partial artifact at --out")
    ap.add_argument("--no-thetas", action="store_true",
                    help="do not store per-replicate theta_qn in the "
                         "artifact")
    ap.add_argument("--list", action="store_true",
                    help="print the expanded grid and groups, then exit")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the machine axis over the ranks of a "
                         "torch.distributed world, one device each")
    ap.add_argument("--max-batch", type=int, default=None, metavar="N",
                    help="chunk groups larger than N scenarios (the "
                         "artifact is written after every chunk)")
    ap.add_argument("--accountant", default=None,
                    choices=privacy.registered(),
                    help="override every scenario's privacy accountant")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    scenarios = build_preset(args.preset)
    if args.fast:
        scenarios = fast_variant(scenarios)
    if args.accountant is not None:
        scenarios = [dataclasses.replace(s, accountant=args.accountant)
                     for s in scenarios]
    groups = group_scenarios(scenarios)
    print(f"preset {args.preset!r}: {len(scenarios)} scenarios in "
          f"{len(groups)} group(s)")
    if args.list:
        for key, scens in groups.items():
            print(f"  {group_label(key)}  [{len(scens)} scenario(s)]")
            for s in scens:
                print(f"    {s.scenario_id()}")
        return 0

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        print(f"error: {err}", file=sys.stderr)
        return 1
    with sharded_run(None, device, args.sharded) as mesh:
        return _run(args, scenarios, device, mesh)


def _run(args, scenarios, device, mesh) -> int:
    say = print if rank0() else (lambda *a, **k: None)
    out = args.out or _default_out(args.preset)
    if mesh is not None:
        say(f"sharding the machine axis over {mesh.size()} rank(s)")
    executor = SweepExecutor(device=device, progress=say,
                             chunk_size=args.max_batch, mesh=mesh)
    t0 = time.perf_counter()
    art = executor.run(scenarios, artifact_path=out,
                       resume=not args.no_resume,
                       store_thetas=not args.no_thetas,
                       meta={"preset": args.preset, "fast": args.fast})
    dt = time.perf_counter() - t0
    if not rank0():
        return 0
    print(_summarize(art))
    print(f"\n{len(art['scenarios'])} scenario(s) in artifact; this run: "
          f"{len(executor.launches)} scenario(s) on {device} in {dt:.3f} s, "
          f"{sum(executor.launches.values())} order-statistics kernel "
          f"launch(es)")
    print(f"wrote {out}")
    if args.csv:
        artifact_mod.to_csv(art, args.csv)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
