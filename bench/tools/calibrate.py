#!/usr/bin/env python3
"""Readings that a cell's limits are set from: the numbers that decide
``correct`` for the program over many seeds, and for the control and the
planted faults.

    python3 bench/tools/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control [--faults control,half,alter,nonoise,sigma2]] \\
        [--rounds N] [--out FILE]

For each seed, in one process: the cell's set-up (its first steps, or its
warm-up and ``--rounds`` further rounds), then the numbers compared with
the plain reference. With ``--control``, each of ``--faults`` in the
program's place instead, against the reference: ``control`` is the
reference in the precision below the configuration's, the others the
reference with that fault planted. With ``--control`` and no
``--rounds`` the program is not run: the glm4 cells' control is the
reference alone; the serve cell's compares the rounds that ``--rounds``
served. One JSON line per seed and reading, on standard output and
appended to ``--out``. Runs where the benchmark runs: on the card."""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))

FAULTS = ("control", "half", "alter", "nonoise", "sigma2")


def main():
    from bench.lib.harness import Context, load_json, load_module
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="control",
                    help="with --control: a comma-separated list of "
                         + ", ".join(FAULTS))
    ap.add_argument("--rounds", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args()
    faults = a.faults.split(",") if a.control else [None]
    if any(f not in FAULTS for f in faults if f is not None):
        ap.error(f"--faults takes {', '.join(FAULTS)}")
    w = load_json(ROOT / "bench" / "workloads" / f"{a.workload}.json")
    c = load_json(ROOT / "bench" / "configs" / f"{w['config']}.json")
    drv = load_module(ROOT / "bench" / "drivers" / f"{w['driver']}.py",
                      w["driver"])
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        cell = drv.build(Context(ROOT, a.workload, w, c, seed, a.device))
        if not a.control or a.rounds:
            cell.setup()
            for _ in range(a.rounds):
                cell.step()
            cell.close()
        setup_s = time.perf_counter() - t0
        for fault in faults:
            t1 = time.perf_counter()
            if fault is None:
                nums = cell.numbers()
            else:
                nums = cell.control_numbers(None if fault == "control"
                                            else fault)
            line = json.dumps({
                "workload": a.workload, "seed": seed, "control": a.control,
                "fault": fault, "numbers": nums,
                "readings": getattr(cell, "readings", None),
                "ref_readings": getattr(cell, "ref_readings", None),
                "setup_s": setup_s,
                "reference_s": time.perf_counter() - t1})
            print(line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
        del cell
        gc.collect()
        if a.device.startswith("cuda"):
            import torch
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
