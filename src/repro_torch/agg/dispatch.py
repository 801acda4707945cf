"""Measured backend-dispatch table for ``repro_torch.agg`` —
``repro/agg/dispatch.py`` counterpart.

``backend=None`` used to mean a platform rule: the CUDA kernel (B1,
``csrc/ostat.cu``) for every CUDA tensor with the lane count that
:func:`repro_torch.agg.kernel.ostat_plan` guesses from the shape, the plain
PyTorch reference for a CPU tensor. The autotuner
(:mod:`repro_torch.agg.autotune`) measures instead, over a grid of
``(B, m, p)`` problems, and records the winners into a versioned JSON
table, one file per platform. What a table may choose depends on its
platform:

  * ``cuda``: only B1's launch parameters (``lanes``). A CUDA tensor
    always runs the kernel: plain PyTorch never stands in for B1 on the
    card, so a ``cuda`` table records the kernel backends alone and
    refuses any other.
  * ``cpu``: the reference or the kernel's plain version (``"sort"`` or
    ``"bisect"`` for a masked rule), as the reference package's table
    chooses between its oracle and its kernel.

Lookup is shape-bucketed: ``(B, m, p)`` maps to the key
``B<log2 B>:m<log2 m>:p<log2 p>`` (floor log2 per axis), so one measured
entry covers its whole power-of-two neighbourhood. The policy for
``backend=None``:

  * a table for the tensor's platform, bucket measured -> the recorded
    best backend with its recorded kernel parameters;
  * a table for the platform, bucket UNmeasured, or no table for the
    platform -> the platform rule with no parameters: the kernel
    (``"kernel"``, or ``"bisect"`` for a ``masked:<rule>`` op) at the
    planner's lanes on ``cuda``, the reference (``"sort"``) on ``cpu``. So
    a CPU run without a table is unchanged, and an unmeasured lane count
    never runs.

The platform is the tensor's ``device.type`` (``"cuda"`` or ``"cpu"``);
a table whose ``platform`` is another is ignored. The backends are the
port's own: ``"kernel"``/``"reference"``, and ``"bisect"``/``"sort"``
for the masked serving forms (op ``masked:<rule>``). The schema and the
environment variable are the port's own too, so a JAX table never steers
the port, nor the reverse.

The table for the card is committed at ``tables/cuda.json``, measured
on an H100 by ``python -m repro_torch.agg.autotune``; no CPU table is
committed. ``REPRO_TORCH_AGG_DISPATCH=<path>`` points dispatch at a
re-tuned table without touching the package (a path with no file raises),
and :func:`set_table` injects one in-process (tests, notebooks), or
:data:`NO_TABLE` to run a platform without one.

Every tuning parameter is an int (``Decision.params`` is validated on
load), as in the reference, where they are jit static arguments.

:func:`decide` counts what it resolves, per ``(op, bucket, source,
backend)``: :func:`decisions` reads the counts and
:func:`reset_decisions` clears them, so a run can report which backend
every shape went to.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
from pathlib import Path
from typing import Dict, Optional, Tuple

SCHEMA = "repro_torch.agg.dispatch/v1"

#: committed per-platform tables (``cuda.json`` ships as package data)
TABLE_DIR = Path(__file__).resolve().parent / "tables"

#: environment override: path to a re-tuned table for this platform
ENV_VAR = "REPRO_TORCH_AGG_DISPATCH"

#: kernel tuning parameters a table entry may carry (ints): the kernel
#: wrapper's lanes per coordinate
PARAM_KEYS = ("lanes",)

#: the kernel-backed backends (one B1 launch per call on a CUDA tensor),
#: the only ones a ``cuda`` table may record
KERNEL_BACKENDS = ("kernel", "bisect")

#: ``set_table(NO_TABLE, platform)`` runs ``platform`` without a table
NO_TABLE = object()


@dataclasses.dataclass(frozen=True)
class Decision:
    """One dispatch outcome: which backend to run and how it was chosen.

    ``params`` are the measured kernel tuning ints (empty for the
    reference, the masked sort and every fallback: the kernel then lays
    itself out by its planner); ``measured`` is False
    when the decision came from a fallback rather than a table entry;
    ``source`` says which ("table", "fallback-unmeasured",
    "fallback-no-table").
    """
    backend: str
    params: Dict[str, int]
    measured: bool
    source: str


def bucket_of(B: int, m: int, p: int) -> str:
    """Shape-bucket key: floor-log2 per axis, e.g. (320, 8, 10) ->
    ``"B8:m3:p3"``. One measured entry serves its whole power-of-two
    neighbourhood."""
    def lg(x):
        # repro-torch: allow(step-sync) — host-only: x is a Python int, one
        # axis of a shape
        return max(int(x), 1).bit_length() - 1
    return f"B{lg(B)}:m{lg(m)}:p{lg(p)}"


def _fallback_backend(op: str, platform: str) -> str:
    masked = op.startswith("masked:")
    if platform == "cuda":
        return "bisect" if masked else "kernel"
    return "sort" if masked else "reference"


class DispatchTable:
    """In-memory form of one platform's measured dispatch table."""

    def __init__(self, platform: str, entries: Optional[dict] = None,
                 meta: Optional[dict] = None):
        self.platform = platform
        self.entries: dict = entries if entries is not None else {}
        self.meta: dict = meta if meta is not None else {}

    # ------------------------------------------------------------ record

    def record(self, op: str, B: int, m: int, p: int, backend: str,
               time_s: float, gate_err: Optional[float] = None,
               **params) -> None:
        """Record one measured backend timing for a shape bucket, with the
        error the autotuner's correctness gate measured (kernel backends).
        Tuning params must be ints, and a ``cuda`` table records only the
        kernel backends; the bucket's ``best`` backend is recomputed on
        every record."""
        bad = {k: v for k, v in params.items() if not isinstance(v, int)}
        if bad:
            raise TypeError(f"non-int tuning params {bad!r} for {op}: "
                            "table params must be ints")
        self._check_backend(op, backend)
        key = f"{op}|{bucket_of(B, m, p)}"
        entry = self.entries.setdefault(key, {"backends": {}, "best": None})
        rec = {"time_s": float(time_s)}
        if gate_err is not None:
            rec["gate_err"] = float(gate_err)
        if params:
            rec["params"] = dict(params)
        entry["backends"][backend] = rec
        entry["best"] = min(entry["backends"],
                            key=lambda b: entry["backends"][b]["time_s"])

    def _check_backend(self, what: str, backend: str) -> None:
        if self.platform == "cuda" and backend not in KERNEL_BACKENDS:
            raise ValueError(
                f"{what}: a cuda table records only the kernel backends "
                f"{KERNEL_BACKENDS}, not {backend!r}: on the card B1 runs, "
                "and the table picks its launch parameters")

    # ------------------------------------------------------------ lookup

    def best(self, op: str, B: int, m: int,
             p: int) -> Optional[Tuple[str, Dict[str, int]]]:
        """The measured-best (backend, params) for this shape bucket, or
        None when the bucket was never measured for this op."""
        entry = self.entries.get(f"{op}|{bucket_of(B, m, p)}")
        if not entry or not entry.get("best"):
            return None
        backend = entry["best"]
        params = entry["backends"][backend].get("params", {})
        return backend, {k: int(v) for k, v in params.items()
                         if k in PARAM_KEYS}

    # ------------------------------------------------------- (de)serialize

    def to_json(self) -> dict:
        return {"schema": SCHEMA, "platform": self.platform,
                "meta": dict(self.meta),
                "entries": {k: self.entries[k]
                            for k in sorted(self.entries)}}

    @classmethod
    def from_json(cls, payload: dict) -> "DispatchTable":
        if payload.get("schema") != SCHEMA:
            raise ValueError(
                f"dispatch table schema {payload.get('schema')!r} != "
                f"{SCHEMA}; re-tune with python -m repro_torch.agg.autotune")
        table = cls(payload["platform"], meta=dict(payload.get("meta", {})))
        for key, entry in payload.get("entries", {}).items():
            for backend, rec in entry.get("backends", {}).items():
                params = rec.get("params", {})
                bad = {k: v for k, v in params.items()
                       if not isinstance(v, int)}
                if bad:
                    raise ValueError(
                        f"dispatch entry {key!r}/{backend} carries non-int "
                        f"params {bad!r}")
                table._check_backend(f"dispatch entry {key!r}", backend)
            table.entries[key] = {
                "backends": {b: dict(r)
                             for b, r in entry["backends"].items()},
                "best": entry.get("best")}
        return table

    def save(self, path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path) -> "DispatchTable":
        with open(path) as f:
            return cls.from_json(json.load(f))


# ------------------------------------------------------- module-level cache

#: platform -> DispatchTable | None (None = looked, no table on disk)
_CACHE: dict = {}
#: test/in-process injection: platform -> DispatchTable | None (NO_TABLE)
_INJECTED: dict = {}
#: (op, bucket, source, backend) -> decisions made since the last reset
_DECISIONS: collections.Counter = collections.Counter()


def clear_cache() -> None:
    """Drop loaded tables (picks up a changed ENV_VAR / table file)."""
    _CACHE.clear()


def set_table(table,
              platform: Optional[str] = None) -> None:
    """Inject a table for its own platform (``platform``, where given,
    must be that one) ahead of any on-disk file;
    ``set_table(NO_TABLE, platform)`` runs ``platform`` without a table
    (its platform rule); ``set_table(None, platform)`` removes that
    platform's injection and ``set_table(None)`` removes all of them."""
    if table is None:
        if platform is None:
            _INJECTED.clear()
        else:
            _INJECTED.pop(platform, None)
    elif table is NO_TABLE:
        if platform is None:
            raise ValueError("set_table(NO_TABLE) needs the platform")
        _INJECTED[platform] = None
    else:
        if platform not in (None, table.platform):
            raise ValueError(f"a {table.platform} table cannot steer "
                             f"{platform}")
        _INJECTED[table.platform] = table
    clear_cache()


def load_table(platform: str) -> Optional[DispatchTable]:
    """The active table for ``platform`` (``"cuda"`` or ``"cpu"``):
    injected > $REPRO_TORCH_AGG_DISPATCH > committed tables/<platform>.json;
    None when there is none for this platform. Raises where the
    environment variable names no file."""
    if platform in _INJECTED:
        return _INJECTED[platform]
    if platform not in _CACHE:
        table = None
        env = os.environ.get(ENV_VAR)
        path = Path(env) if env else TABLE_DIR / f"{platform}.json"
        if env and not path.is_file():
            raise FileNotFoundError(f"${ENV_VAR}={env}: no dispatch table "
                                    "there")
        if path.is_file():
            table = DispatchTable.load(path)
            if table.platform != platform:
                table = None        # a cpu table must not steer a cuda run
        _CACHE[platform] = table
    return _CACHE[platform]


def decide(op: str, B: int, m: int, p: int, platform: str) -> Decision:
    """Resolve ``backend=None`` for one aggregation problem on
    ``platform`` (the entry points pass their tensor's ``device.type``),
    and count the decision. See the module docstring for the policy.
    ``"meta"`` (a dry-run trace) gets the card's decision, so the trace is
    the card's program, and is not counted: no card decided it."""
    trace = platform == "meta"
    if trace:
        platform = "cuda"
    table = load_table(platform)
    hit = None if table is None else table.best(op, B, m, p)
    if hit is not None:
        dec = Decision(hit[0], hit[1], True, "table")
    else:
        dec = Decision(_fallback_backend(op, platform), {}, False,
                       "fallback-no-table" if table is None
                       else "fallback-unmeasured")
    if not trace:
        _DECISIONS[(op, bucket_of(B, m, p), dec.source, dec.backend)] += 1
    return dec


def decisions() -> Dict[Tuple[str, str, str, str], int]:
    """``{(op, bucket, source, backend): count}`` of the decisions made
    since the last :func:`reset_decisions`."""
    return dict(_DECISIONS)


def reset_decisions() -> None:
    """Clear the decision counts."""
    _DECISIONS.clear()
