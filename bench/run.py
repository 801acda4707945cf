#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

    python3 bench/run.py --workload <cell> --seed <n>
        --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for (``BENCHMARK.json``). Set-up makes the cell's inputs and weights on the
card from ``--seed`` and warms up every shape the window uses; the window
then runs the cell's closed loop for ``--seconds``; afterwards the plain
reference under ``bench/reference`` checks what the timed path produced.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last the numbers compared with their limits, which are
also the last lines of standard error). With ``--trace 0`` the metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from a profiler trace of the whole window.

Exits 2 and prints no result without a CUDA card, with fewer cards than
the cell asks for, or when a module of JAX or of the JAX package ``repro``
is loaded in this process. Caches of compiled code stay inside the
checkout (``.bench_cache/``); the port's kernels build into their own
``_build`` directories there.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from bench.lib.harness import Refused, run_cell
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace), t_start=T_START)
    except Refused as exc:
        print(f"bench: refused: {exc}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
