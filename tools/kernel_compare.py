#!/usr/bin/env python3
"""Time kernels B1 and B2 of one or more checkouts of this repository on one
CUDA card, each checkout in its own process, one after another.

    python3 tools/kernel_compare.py [--lanes] [--ostat] [--decode] [--out FILE]
                                    TREE [TREE ...]

TREE is the root of a checkout; its ``src/repro_torch`` is imported and its
kernels are built from its own sources. Give the same trees in the order
parent, change, change, parent to pair two versions within one call. For each
tree the script prints one JSON line with:

* ``b2``: the GQA flash-decode wrapper at the main decode shape (glm4-9b's
  heads, B = 8, S = 32,768, Dh = 128, bf16) at cache_len 32,768, 4,096, 16 and
  a ragged vector: device ms from a CUDA-graph replay, the eager ms per call
  (the host's time per call where the host is slower than the card) and the
  plan the wrapper chose, each result held against the plain version;
* ``b2_chunks``: where the tree's library takes the chunk count as an
  argument, the same kernel launched through its C entry point at each of
  CHUNKS chunks per (sequence, kv head) and the three cache_len cases, so
  that two versions are compared at one plan;
* ``b1``: the order-statistics wrapper's device ms and eager ms per call at
  the paper's shape 20 x 51 x 10 (median and dcq);
* with ``--lanes``, ``b1_lanes``: B1's median under every lane count the
  kernel takes at LANE_SHAPES, beside the plan's own choice, each result
  bit-equal to the plain version;
* with ``--ostat``, ``b1_phase3``: ``chip_smoke.py``'s phase 3 (every op
  at every shape, timed and held against the plain version, and the
  lane-group edges);
* with ``--decode``, ``decode`` (run first): ``chip_smoke.py``'s ctx-short
  decode run (glm4-9b at full width, B = 8, 16 + 48 steps from an empty
  cache) through the tree's ``Model``: tokens/s, the median step and one
  step's trace; then WRAPPER_STEPS more steps with the host's time spent
  inside the B2 wrapper per step.

The timing and checking helpers are ``chip_smoke.py``'s. Nothing here is
imported by the port or run by ``chip_smoke.py``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

MAIN = (8, 32768, 32, 2, 128)
RAGGED = (1, 100, 1000, 4096, 8000, 16384, 30000, 32768)
CASES = (("full", [32768] * 8), ("4096", [4096] * 8), ("16", [16] * 8),
         ("ragged", list(RAGGED)))
CHUNKS = (8, 16, 24, 32)
LANE_SHAPES = ((1, 8, 262144), (8, 8, 4096), (320, 8, 10), (20, 51, 10),
               (1, 51, 262144))
WRAPPER_STEPS = 16


def _b2(smoke, g):
    import torch
    from repro_torch.kernels import gqa_decode as gqa
    B, S, Hq, Hkv, Dh = MAIN
    lib = gqa.build()
    takes_chunks = hasattr(gqa, "split_plan")
    rows, forced = [], []
    for label, lens in CASES:
        q, k, v, cl = smoke._gqa_inputs(g, MAIN, torch.bfloat16, lens)
        got = gqa.gqa_decode(q, k, v, cl)
        smoke.gqa_check(got, q, k, v, cl, f"{label}")
        row = {"case": label,
               "ms": smoke.graph_ms(lambda: gqa.gqa_decode(q, k, v, cl), 20),
               "eager_ms": smoke.eager_ms(
                   lambda: gqa.gqa_decode(q, k, v, cl), 50)}
        if takes_chunks:
            row["plan"] = dataclasses.asdict(gqa.plan_for(q, k))
        rows.append(row)
        if takes_chunks and label != "16":
            for n_chunks in CHUNKS:
                out = torch.empty_like(q)
                pm = torch.empty((B, Hkv, n_chunks, Hq // Hkv),
                                 device="cuda")
                pl = torch.empty_like(pm)
                pa = torch.empty((B, Hkv, n_chunks, Hq // Hkv, Dh),
                                 device="cuda")

                def call():
                    rc = lib.gqa_decode_launch(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        cl.data_ptr(), out.data_ptr(), pm.data_ptr(),
                        pl.data_ptr(), pa.data_ptr(), B, S, Hkv, Hq // Hkv,
                        Dh, n_chunks, 1, gqa.softmax_scale(Dh),
                        torch.cuda.current_stream().cuda_stream)
                    smoke.check(rc == 0, f"launch failed ({rc})")
                call()
                smoke.gqa_check(out, q, k, v, cl, f"{label} {n_chunks}")
                forced.append({"case": label, "n_chunks": n_chunks,
                               "ms": smoke.graph_ms(call, 20)})
        del q, k, v
    resident = None
    if hasattr(lib, "gqa_decode_occupancy"):
        res = ctypes.c_int(0)
        smoke.check(lib.gqa_decode_occupancy(Hq // Hkv, Dh, 1,
                                             ctypes.byref(res)) == 0,
                    "occupancy query failed")
        resident = res.value
    return rows, forced, resident


def _b1(smoke, g):
    import torch
    from repro_torch.agg import kernel
    v = torch.randn((20, 51, 10), generator=g, device="cuda")
    sc = torch.rand((20, 10), generator=g, device="cuda") + 0.1
    out = []
    for op in ("median", "dcq"):
        scale = sc if op == "dcq" else None

        def run():
            return kernel.ostat(v, op, scale)
        out.append({"op": op, "shape": [20, 51, 10],
                    "ms": smoke.graph_ms(run, 100),
                    "eager_ms": smoke.eager_ms(run, 100)})
    return out


def _b1_lanes(smoke, g):
    """Median under every lane count (with the register rows that lane
    count needs), the plan swapped in for the call."""
    import torch
    from repro_torch.agg import kernel
    planner = kernel.ostat_plan
    out = []
    try:
        for shape in LANE_SHAPES:
            B, m, p = shape
            v = torch.randn(shape, generator=g, device="cuda")
            plain = kernel.ostat_plain(v, "median")
            chosen = planner(B, m, p, *kernel._card(0))
            times = {}
            for lanes in (1, 2, 4, 8, 16, 32):
                rows = -(-m // lanes)
                reg = next((r for r in kernel.REG_ROWS if r >= rows), 0)
                if reg == 0 and lanes < 32:
                    continue
                plan = kernel.OstatPlan(lanes, reg, reg == 0)
                kernel.ostat_plan = lambda *a, _p=plan: _p
                smoke.check(bool((kernel.ostat(v, "median") == plain).all()),
                            f"median with {lanes} lanes at {shape} differs "
                            f"from the plain version")
                times[lanes] = smoke.graph_ms(
                    lambda: kernel.ostat(v, "median"), 100)
                kernel.ostat_plan = planner
            out.append({"shape": list(shape),
                        "plan": dataclasses.asdict(chosen), "ms": times})
    finally:
        kernel.ostat_plan = planner
    return out


def _decode(smoke, g):
    """The ctx-short run, then WRAPPER_STEPS more steps from an empty cache
    with the host's time inside the B2 wrapper summed per step (no sync
    inside; each step ends in one)."""
    import statistics
    import time

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.models.model import Model
    model = Model(get_config(smoke.GLM), generator=g)
    row = smoke._decode_run(model, "ctx-short", 0, g)
    res = {k: row[k] for k in ("tokens_per_s", "median_step_ms", "trace")}
    cache = model.init_cache(smoke.DECODE_B, smoke.DECODE_LEN)
    tok = torch.zeros((smoke.DECODE_B, 1), dtype=torch.long, device="cuda")
    real, spent = gqa.gqa_decode, [0.0]

    def timed(*args):
        t0 = time.perf_counter()
        out = real(*args)
        spent[0] += time.perf_counter() - t0
        return out
    gqa.gqa_decode = timed
    steps, inside = [], []
    try:
        for _ in range(WRAPPER_STEPS):
            spent[0] = 0.0
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, {"tokens": tok})
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            inside.append(spent[0] * 1e3)
            tok = logits.argmax(-1)
    finally:
        gqa.gqa_decode = real
    res["wrapper_steps"] = {"step_ms": steps, "b2_wrapper_host_ms": inside,
                            "median_step_ms": statistics.median(steps),
                            "median_b2_wrapper_host_ms":
                                statistics.median(inside)}
    del cache
    return res


def one(tree: Path, lanes: bool, ostat: bool, decode: bool) -> dict:
    """Every measurement of one checkout, in this process."""
    import torch
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    g = torch.Generator(device="cuda")
    g.manual_seed(4321)
    # the decode run first, so that no other measurement runs before it
    res = {"tree": str(tree)}
    if decode:
        res["decode"] = _decode(smoke, g)
    b2, forced, resident = _b2(smoke, g)
    res.update({"resident_per_sm": resident, "b2": b2, "b2_chunks": forced,
                "b1": _b1(smoke, g)})
    if lanes:
        res["b1_lanes"] = _b1_lanes(smoke, g)
    if ostat:
        res["b1_phase3"] = smoke.phase_kernel()[0]
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", type=Path)
    ap.add_argument("--lanes", action="store_true",
                    help="also time B1's median under every lane count")
    ap.add_argument("--ostat", action="store_true",
                    help="also run chip_smoke.py's phase 3 (B1, every op "
                         "and shape)")
    ap.add_argument("--decode", action="store_true",
                    help="also time chip_smoke.py's ctx-short decode run")
    ap.add_argument("--out", type=Path, help="write all results here")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(one(args.trees[0].resolve(), args.lanes,
                             args.ostat, args.decode)), flush=True)
        return
    results = []
    for tree in args.trees:
        cmd = [sys.executable, __file__, "--one", str(tree.resolve())]
        cmd += [f"--{flag}" for flag in ("lanes", "ostat", "decode")
                if getattr(args, flag)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=False, timeout=900)
        if res.returncode != 0:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise SystemExit(f"{tree}: exit {res.returncode}")
        line = res.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
