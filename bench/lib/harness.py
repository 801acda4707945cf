"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Everything that belongs to one cell is found by name:

* ``bench/workloads/<workload>.json``: the cell's traffic, its
  configuration's name, its driver's name, and the limits of the
  numbers that decide ``correct``;
* ``bench/configs/<config>.json``: the configuration as it is run;
* ``bench/drivers/<driver>.py``: ``build(ctx)`` returns the cell, an
  object with ``setup()``, ``step() -> dict``, ``close()``, ``check() ->
  [{"name", "value", "limit"}]`` and ``b1_launches() -> [(B, m, p,
  value_bytes, count)]`` (the aggregations of the window's steps);
* ``bench/metrics/<metric>.py``: ``read(run) -> float | None`` for every
  metric of ``BENCHMARK.json`` that the cell reports.

A later cell, configuration or metric is new files of these kinds; this
module needs no edit for it.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

#: top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """A run that may print no result (no card, a forbidden import)."""


@dataclass
class Context:
    """What a driver is given: the checkout's root, the cell's workload
    and configuration, the seed, and the device it runs on."""
    root: Path
    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    device: str = "cuda"


@dataclass
class Run:
    """A finished run, as the metric readers see it."""
    ctx: Context
    cell: Any
    setup_s: float
    window_s: float
    steps: List[Dict[str, Any]]
    peak_window_bytes: int
    trace: Any = None
    power_limit_w: Optional[float] = None

    def total(self, key: str) -> float:
        return sum(s.get(key, 0) for s in self.steps)

    def rate(self, key: str) -> Optional[float]:
        """``key`` summed over every step of the window, over the window's
        seconds (None where no step counts it)."""
        if not any(key in s for s in self.steps) or self.window_s <= 0:
            return None
        return self.total(key) / self.window_s


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def cell_metrics(bench: Dict, name: str, kind: str) -> List[Dict]:
    """The metrics of ``bench[kind]`` that cell ``name`` reports: those
    that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if "workloads" not in m or name in m["workloads"]]


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, None where it cannot be
    read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=False).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    return sorted({n for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             *, t_start: float, device: str = "cuda",
             log=None) -> Dict[str, Any]:
    """Run cell ``name`` of the checkout at ``root`` and return its result
    line (a dict). Raises :class:`Refused` where no result may be
    printed. On ``device="cuda"`` the cell's cards are looked for first;
    another device runs the same path without them."""
    import torch
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    workload = load_json(root / "bench" / "workloads" / f"{name}.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    chips = entry["chips"] if entry else 1
    cuda = device.startswith("cuda")
    if cuda:
        if not torch.cuda.is_available():
            raise Refused("no CUDA card: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} cards, "
                          f"{torch.cuda.device_count()} visible")
    config = load_json(root / "bench" / "configs"
                       / f"{workload['config']}.json")
    ctx = Context(root=root, name=name, workload=workload, config=config,
                  seed=int(seed), device=device)
    driver = load_module(root / "bench" / "drivers"
                         / f"{workload['driver']}.py", workload["driver"])
    kind = "per_layer" if trace else "end_to_end"
    wanted = cell_metrics(bench, name, kind)
    readers = {m["name"]: load_module(root / "bench" / "metrics"
                                      / f"{m['name']}.py", m["name"])
               for m in wanted}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cell = driver.build(ctx)
    cell.setup()
    sync()
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    log(f"bench: {name} seed {seed}: set-up {setup_s:.3f} s")

    steps: List[Dict[str, Any]] = []
    if trace:
        from bench.lib.trace import Recorder, window_span
        recorder, span = Recorder(), window_span()
    else:
        recorder, span = contextlib.nullcontext(), contextlib.nullcontext()
    with recorder, span:
        t0 = time.perf_counter()
        t_end = t0
        while t_end - t0 < seconds:
            out = cell.step()
            t_end = time.perf_counter()
            steps.append(out)
    window_s = t_end - t0
    sync()
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"bench: window {window_s:.3f} s, {len(steps)} steps")
    run = Run(ctx=ctx, cell=cell, setup_s=setup_s, window_s=window_s,
              steps=steps, peak_window_bytes=peak_window,
              trace=recorder.trace if trace else None,
              power_limit_w=power_limit_w() if cuda else None)
    if trace and run.trace is None:
        raise Refused("the profiler recorded no window")

    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    if run.trace is not None:
        breakdown = {"device_ops": run.trace.device_ops(10),
                     "idle_gaps": run.trace.idle_gaps(10)}

    cell.close()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {found}")
    t_ref = time.perf_counter()
    checks = cell.check()
    log(f"bench: reference {time.perf_counter() - t_ref:.3f} s")
    found = forbidden_modules()
    if found:
        raise Refused(f"forbidden modules loaded: {found}")

    failed = sum(1 for s in steps if not s.get("ok", True))
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips,
           "memory_peak_bytes": max(peak_setup, peak_window),
           "power_limit_w": run.power_limit_w}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
    result = {"correct": correct, "attempted": len(steps), "failed": failed,
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result
