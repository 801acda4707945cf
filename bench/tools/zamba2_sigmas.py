#!/usr/bin/env python3
"""Write each leaf's DP sigma into a Zamba2 workload file.

    python3 bench/tools/zamba2_sigmas.py bench/workloads/<cell>.json \\
        [--configs DIR]

As ``tools/sigmas.py`` over the leaves of ``bench.reference.zamba2``: the
workload's ``dp`` states ``eps``, ``delta``, ``gamma``, ``n`` (samples per
machine) and ``transmissions`` (the budget split evenly over them), and
every leaf gets ``bench.lib.dp.sigma`` at its own dimension, written to
the workload's top-level ``sigmas``."""
import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.lib.dp import sigma  # noqa: E402
from bench.reference.zamba2 import leaf_specs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("workload")
    ap.add_argument("--configs", default=str(ROOT / "bench" / "configs"))
    a = ap.parse_args()
    path = Path(a.workload)
    w = json.loads(path.read_text())
    c = json.loads((Path(a.configs) / f"{w['config']}.json").read_text())
    dp = w["dp"]
    k = dp.get("transmissions", 1)
    w["sigmas"] = {
        p: sigma(math.prod(shape), dp["n"], dp["gamma"], dp["eps"] / k,
                 dp["delta"] / k) for p, shape, _ in leaf_specs(c)}
    path.write_text(json.dumps(w, indent=2) + "\n")


if __name__ == "__main__":
    main()
