"""Backend autotuner for the order-statistics aggregation —
``repro/agg/autotune.py`` counterpart.

For every registered aggregator with a kernel form (plus the fused
``median_mad_dcq`` pass and the masked serving rules with a bisect form)
this measures, over a grid of ``(B, m, p)`` problem shapes on the CURRENT
device, what dispatch may choose there, and records the winners into a
:class:`repro_torch.agg.dispatch.DispatchTable`:

    python -m repro_torch.agg.autotune --out src/repro_torch/agg/tables/cuda.json

* On the card B1 always runs, so the candidates are its lane counts
  (:func:`repro_torch.agg.kernel.lane_counts`, those the kernel runs at
  every ``m`` of the bucket), and the incumbent is the lane count
  :func:`~repro_torch.agg.kernel.ostat_plan` picks. One record per
  bucket: the kernel with the winning ``lanes``.
* On the CPU the candidates are the reference and the kernel's plain
  version (``"sort"`` and ``"bisect"`` for a masked rule), the reference
  the incumbent; both are recorded.

A candidate wins only by more than the noise: each is timed in
``rounds`` rounds, the incumbent at its fastest round and a challenger at
its slowest, so a challenger displaces the incumbent only where every
round of it beat every round of the incumbent. A masked rule is timed
over one flush of a full ring and one at :data:`PARTIAL_FILL` of it, the
two fills a fleet's ring flushes at (``chip_smoke.py`` serves its fleets
so).

Candidates must pass a correctness gate (99.9th-percentile abs error vs
the reference oracle below ``tol``, see :func:`_gate_err` for why not the
max) before their timing counts. Each record keeps its gate error
(``gate_err``). Every recorded tuning parameter is an int. The oracle runs
over column blocks of a large problem (every tuned rule is
coordinate-wise, so the blocks compute the same).

Timings use an injectable ``timer`` (default ``time.perf_counter``), each
round the mean of ``reps`` calls after one warm-up, between
``torch.cuda.synchronize()`` calls on the card; with a fixed clock and
fixed seeds the emitted table is byte-stable. Inputs come from a seeded
``torch.Generator`` on the device.
"""
from __future__ import annotations

import argparse
import math
import subprocess
import time

import torch

from repro_torch.agg import get_aggregator, kernel, median_mad_dcq, \
    registered
from repro_torch.agg.dispatch import SCHEMA, TABLE_DIR, DispatchTable

__all__ = ["DEFAULT_SHAPES", "FAST_SHAPES", "DEFAULT_MASKED_SHAPES",
           "autotune", "main"]

#: (B, m, p) problem shapes tuned by default: the reference's five (the
#: sweep's hot loop, one protocol round at paper scale, mid- and large-p
#: gradient problems), then every bucket the port's paths hit on the card
#: (read off the dispatch decision log of ``chip_smoke.py``): Algorithm 1
#: at the paper's sizes and the sweep presets' replicate batches, and the
#: trainers' leaves of 4 machines from 8 to 2^29 coordinates (the largest,
#: glm4-9b's 620.8M-coordinate embedding, falls in 2^29's bucket).
DEFAULT_SHAPES = (
    (320, 8, 10),        # sweep hot loop: B scenarios x (m, p) tiles
    (1, 8, 10),          # one protocol round at paper scale
    (8, 8, 4096),        # mid-p: a small grid of gradient-sized problems
    (1, 8, 4096),
    (1, 8, 262144),      # large-p: one model-gradient-sized problem
    (20, 51, 10),        # Figure 1: 20 replicates, m + 1 = 51
    (20, 50, 10),        # untrusted R2b variance: the m = 50 nodes
    (1, 51, 1),          # s1 summary median, m = 50
    (20, 81, 10),        # Figures 3/6: m + 1 = 81
    (1, 81, 1),          # s1 summary median, m = 80
    (1, 11, 1), (1, 21, 1),             # the sweep presets' s1 summaries
    (1, 51, 10), (1, 51, 100),          # the baselines at Figure 1's size
    (2, 8, 5), (3, 10, 5), (3, 11, 8),  # the presets' replicate batches
    (4, 11, 10), (4, 21, 10), (4, 81, 10), (5, 51, 10),
) + tuple((1, 4, 1 << k) for k in range(3, 30))

#: reduced shapes for CI / smoke runs
FAST_SHAPES = (
    (96, 8, 10),
    (4, 8, 1024),
    (1, 8, 16384),
)

#: masked (serving) capacity tuned per payload width p of the shapes
#: (the fast grid's)
MASKED_CAPACITY = 256

#: (capacity, p) of the masked serving rules tuned by default: the
#: fleets of 64, 1,024 and 16,384 updates of 10 coordinates, the
#: full-width parameter leaves served on a ring of 4 (up to 2^29
#: coordinates), and the reduced configs' leaves on rings of 12, 16 and
#: 64 (the launchers' fleets)
DEFAULT_MASKED_SHAPES = (
    (64, 10), (1024, 10), (16384, 10),
) + tuple((4, 1 << k) for k in range(3, 30)) \
    + tuple((c, 1 << k) for c in (12, 16, 64) for k in range(3, 19))

#: timed rounds per candidate (each ``reps`` calls after a warm-up)
ROUNDS = 3

#: the partial fill a masked rule is tuned at, beside the full ring
PARTIAL_FILL = 0.7

#: elements past which the gate's oracle runs over column blocks
_BLOCK_ELEMS = 1 << 26


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _steady(fn, reps: int, timer) -> float:
    """Steady-state seconds per call: one warm-up, then the mean of
    ``reps`` timed calls between two synchronizations of the card."""
    fn()
    _sync()
    t0 = timer()
    for _ in range(reps):
        fn()
    _sync()
    return (timer() - t0) / reps


def _gate_err(a, b) -> float:
    """Correctness-gate error: the 99.9th-percentile abs deviation
    (nearest rank; a non-finite deviation counts as infinite).

    The CQ estimators are sums of indicators I(v <= med + scale*Delta_k):
    when a value sits within f32 rounding of a knot threshold, last-ulp
    differences between backends flip one indicator and the estimate
    jumps by ~scale/(m*psi_sum) at that single coordinate — an inherent
    discontinuity, not a kernel bug, and at p~1e5+ some coordinate will
    always tie. A genuinely wrong candidate (under-resolved bisection) is
    off at EVERY coordinate, so gating the 99.9th percentile rejects it
    while tolerating isolated tie flips."""
    d = (a.to(torch.float32) - b.to(torch.float32)).abs().flatten()
    d = torch.nan_to_num(d, nan=math.inf)
    k = max(1, math.ceil(0.999 * d.numel()))
    return float(d.sort().values[k - 1])


def _blocks(fn, v, scale):
    """``fn(v, scale)`` over column blocks of the last axis, concatenated
    (one block when ``v`` is small)."""
    p = v.shape[-1]
    cols = max(1, _BLOCK_ELEMS // max(1, v.numel() // max(p, 1)))
    if cols >= p:
        return fn(v, scale)
    parts = [fn(v[..., c:c + cols],
                None if scale is None else scale[..., c:c + cols])
             for c in range(0, p, cols)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(col, dim=-1) for col in zip(*parts))
    return torch.cat(parts, dim=-1)


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _lanes(B: int, m: int, p: int) -> tuple:
    """The lane counts to try at ``(B, m, p)`` on the card: those the
    kernel runs at every m of its bucket (up to ``top`` = 2^(floor log2
    m + 1) - 1 rows) that leave no lane without a row there, the
    planner's first (or the nearest such count above it)."""
    top = (1 << m.bit_length()) - 1
    fits = kernel.lane_counts(top)
    planned = kernel.ostat_plan(B, m, p, *kernel._card(
        torch.cuda.current_device())).lanes
    first = next(g for g in fits if g >= planned)
    return (first,) + tuple(g for g in fits if g != first and g <= top + 1)


def _contest(table, op, B, m, p, candidates, *, reps, rounds, timer, tol,
             log) -> None:
    """Gate and time ``candidates`` — ``(backend, params, call, gate)``
    with the incumbent first; ``gate()`` is the gate error, None for the
    oracle itself — and record each backend's best candidate, timed at
    its fastest round if it is the incumbent and at its slowest
    otherwise. A challenger stops being timed once a round of it is no
    faster than its backend's best so far: it can no longer win."""
    best = {}
    for i, (backend, params, call, gate) in enumerate(candidates):
        tag = f"{backend} {params}" if params else backend
        err = gate()
        if err is not None and err > tol:
            log(f"    {tag}: REJECTED err={err:.2e} > {tol:g}")
            continue
        bar = best[backend][0] if backend in best else math.inf
        times = []
        while len(times) < rounds and (i == 0 or max(times, default=0)
                                       < bar):
            times.append(_steady(call, reps, timer))
        t = min(times) if i == 0 else max(times)
        log(f"    {tag}: {min(times) * 1e3:.4f}-{max(times) * 1e3:.4f} ms"
            f" over {len(times)} round(s)"
            + ("" if err is None else f" (err {err:.2e})"))
        if t < bar:
            best[backend] = (t, params, err)
    for backend, (t, params, err) in best.items():
        table.record(op, B, m, p, backend, t, gate_err=err, **params)
    log(f"  {op} B={B} m={m} p={p}: best {table.best(op, B, m, p)}")


def _tune_op(table: DispatchTable, op: str, B: int, m: int, p: int, *,
             device, **kw) -> None:
    """Measure what dispatch may choose for one (op, shape)."""
    fused = op == "median_mad_dcq"
    agg = None if fused else get_aggregator(op)
    g = torch.Generator(device=device).manual_seed(0)
    v = torch.randn((B, m, p), generator=g, device=device).mul_(2.0)
    scale = None
    if agg is not None and agg.needs_scale:
        scale = torch.randn((B, p), generator=g, device=device).abs_() \
            .add_(0.1)

    def ref(vv, sc):
        if fused:
            return median_mad_dcq(vv, backend="reference")
        return agg.reference(vv, scale=sc, K=10, trim_beta=0.2, axis=-2)

    oracle = _blocks(ref, v, scale)

    def kern(lanes=None):
        return lambda: kernel.ostat(v, op, scale, K=10, trim_beta=0.2,
                                    lanes=lanes)

    def gate(call):
        return lambda: max(_gate_err(o, r) for o, r in zip(
            _tuple(call()), _tuple(oracle)))

    if device.type == "cuda":
        cands = [("kernel", {"lanes": n}, kern(n), gate(kern(n)))
                 for n in _lanes(B, m, p)]
    else:
        cands = [("reference", {}, lambda: ref(v, scale), lambda: None),
                 ("kernel", {}, kern(), gate(kern()))]
    _contest(table, op, B, m, p, cands, **kw)


def _tune_masked(table: DispatchTable, rule: str, C: int, p: int, *,
                 device, **kw) -> None:
    """Measure one masked serving rule at ``(capacity, p)`` over a flush
    of a full ring and one at PARTIAL_FILL of it; recorded under op
    ``masked:<rule>``: on the card the bisect form's lane counts, on the
    CPU the sort against the bisect form."""
    agg = get_aggregator(rule)
    g = torch.Generator(device=device).manual_seed(2)
    v = torch.randn((C, p), generator=g, device=device)
    scale = (torch.randn((p,), generator=g, device=device).abs_().add_(0.1)
             if agg.needs_scale else None)
    fills = (C, max(1, int(PARTIAL_FILL * C)))
    oracle = [_blocks(lambda vv, sc, f=f: agg.masked(vv, f, scale=sc), v,
                      scale) for f in fills]

    def run(fn, **params):
        return lambda: [fn(v, f, scale=scale, **params) for f in fills]

    def gate(call):
        return lambda: max(_gate_err(o, r) for o, r in zip(call(), oracle))

    if device.type == "cuda":
        cands = [("bisect", {"lanes": n}, run(agg.masked_bisect, lanes=n),
                  gate(run(agg.masked_bisect, lanes=n)))
                 for n in _lanes(1, C, p)]
    else:
        cands = [("sort", {}, run(agg.masked), lambda: None),
                 ("bisect", {}, run(agg.masked_bisect),
                  gate(run(agg.masked_bisect)))]
    _contest(table, f"masked:{rule}", 1, C, p, cands, **kw)


def _card_meta() -> dict:
    """The card's name and power limit as nvidia-smi prints them, and the
    toolchain's versions."""
    meta = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if torch.cuda.is_available():
        meta["device"] = torch.cuda.get_device_name(0)
        try:
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60, check=True)
            meta["nvidia_smi"] = smi.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            meta["nvidia_smi"] = None
    return meta


def autotune(ops=None, shapes=DEFAULT_SHAPES, *, device=None,
             reps: int = 3, rounds: int = ROUNDS,
             timer=time.perf_counter, tol: float = 5e-4,
             include_masked: bool = True, masked_shapes=None,
             table: DispatchTable = None, verbose: bool = True
             ) -> DispatchTable:
    """Measure every candidate over ``ops`` x ``shapes`` (and the masked
    rules at ``masked_shapes``, ``(capacity, p)`` pairs; by default
    MASKED_CAPACITY at every p of ``shapes``) on ``device`` (the card
    when there is one) and return the populated dispatch table of its
    platform (extending ``table`` when given).

    Deterministic given a deterministic ``timer``: ops and shapes are
    visited in a fixed order with fixed seeds, so tests can pin a stub
    clock and assert byte-stable output.
    """
    log = print if verbose else (lambda *_a, **_k: None)
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if ops is None:
        ops = [n for n in registered()
               if get_aggregator(n).kernel is not None]
        ops.append("median_mad_dcq")
    if table is None:
        table = DispatchTable(device.type, meta={
            "generated_by": "repro_torch.agg.autotune", "reps": reps,
            "rounds": rounds,
            **(_card_meta() if device.type == "cuda"
               else {"torch": torch.__version__})})
    kw = dict(device=device, reps=reps, rounds=rounds, timer=timer,
              tol=tol, log=log)
    for op in ops:
        for B, m, p in shapes:
            _tune_op(table, op, B, m, p, **kw)
    if include_masked:
        rules = [n for n in registered()
                 if get_aggregator(n).masked_bisect is not None]
        if masked_shapes is None:
            masked_shapes = [(MASKED_CAPACITY, p)
                             for p in sorted({s[2] for s in shapes})]
        for rule in rules:
            for C, p in masked_shapes:
                _tune_masked(table, rule, C, p, **kw)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.agg.autotune",
        description="Autotune repro_torch.agg's backends and write the "
                    "measured dispatch table for this device's platform.")
    ap.add_argument("--out", default=None,
                    help="output table path (default: the committed "
                         f"package table, {TABLE_DIR}/<platform>.json)")
    ap.add_argument("--fast", action="store_true",
                    help="reduced shape grid (CI / smoke runs)")
    ap.add_argument("--ops", nargs="*", default=None,
                    help="subset of ops to tune (default: every registered "
                         "aggregator with a kernel form + the fused pass)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed calls per round")
    ap.add_argument("--rounds", type=int, default=ROUNDS,
                    help="timed rounds per candidate")
    ap.add_argument("--no-masked", action="store_true",
                    help="skip the masked (serving) backends")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda when present)")
    args = ap.parse_args(argv)

    device = torch.device(args.device or ("cuda" if torch.cuda.is_available()
                                          else "cpu"))
    shapes = FAST_SHAPES if args.fast else DEFAULT_SHAPES
    print(f"== repro_torch.agg.autotune: platform={device.type} "
          f"torch={torch.__version__} schema={SCHEMA} ==", flush=True)
    table = autotune(ops=args.ops, shapes=shapes, device=device,
                     reps=args.reps, rounds=args.rounds,
                     include_masked=not args.no_masked,
                     masked_shapes=None if args.fast
                     else DEFAULT_MASKED_SHAPES)
    out = args.out if args.out else TABLE_DIR / f"{device.type}.json"
    path = table.save(out)
    print(f"wrote {len(table.entries)} entries -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
