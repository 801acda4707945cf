"""The port's measured backend dispatch (``repro_torch.agg.dispatch``) and
its autotuner, on the CPU: tests/test_dispatch.py's table and policy
tests through ``set_table``, the table's decision reaching every
aggregation entry point, and the committed card table.

The port's backends are ``"kernel"``/``"reference"`` (``"bisect"``/
``"sort"`` for the masked ops); the platform is the tensor's device type.
A ``cuda`` table records only the kernel backends, so on the card the
table picks B1's lanes and never another backend. On a CPU tensor the
kernel backend is the kernel's plain version, so a decision is seen here
through the wrapper's calls and the decision log.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch import agg
from repro_torch.agg import autotune as at
from repro_torch.agg import dispatch
from repro_torch.agg.dispatch import Decision, DispatchTable, bucket_of
from repro_torch.core.transport import wire_aggregate


@pytest.fixture(autouse=True)
def _clean_dispatch_state(monkeypatch):
    """Every test sees no env override, no injected table, a cold cache
    and an empty decision log."""
    monkeypatch.delenv(dispatch.ENV_VAR, raising=False)
    dispatch.set_table(None)
    dispatch.reset_decisions()
    yield
    dispatch.set_table(None)
    dispatch.reset_decisions()


def _table(platform="cpu"):
    t = DispatchTable(platform)
    t.record("median", 320, 8, 10, "reference", 0.001)
    t.record("median", 320, 8, 10, "kernel", 0.005, lanes=32)
    t.record("median", 1, 8, 262144, "kernel", 0.002, gate_err=0.0,
             lanes=4)
    t.record("median", 1, 8, 262144, "reference", 0.009)
    t.record("masked:median", 1, 256, 4096, "bisect", 0.001)
    t.record("masked:median", 1, 256, 4096, "sort", 0.004)
    return t


def _card_table():
    t = DispatchTable("cuda")
    t.record("median", 320, 8, 10, "kernel", 0.005, lanes=32)
    t.record("median", 1, 8, 262144, "kernel", 0.002, gate_err=0.0,
             lanes=4)
    t.record("masked:median", 1, 256, 4096, "bisect", 0.001, lanes=32)
    return t


def _v(*shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.fixture
def calls(monkeypatch):
    """Every call of the kernel wrapper, as (op, shape, lanes), through
    both ways in (the registry's kernel forms and the masked bisect
    forms)."""
    seen = []
    real = agg.kernel.ostat

    def spy(values, op, scale=None, **kw):
        seen.append((op, tuple(values.shape), kw.get("lanes")))
        return real(values, op, scale, **kw)
    monkeypatch.setattr(agg, "ostat", spy)
    monkeypatch.setattr(agg.kernel, "ostat", spy)
    return seen


# ------------------------------------------------- round trip, validation

def test_table_round_trip(tmp_path):
    t = _table()
    path = t.save(tmp_path / "cpu.json")
    back = DispatchTable.load(path)
    assert back.platform == "cpu" and back.to_json() == t.to_json()
    payload = json.loads(path.read_text())
    assert payload["schema"] == dispatch.SCHEMA == \
        "repro_torch.agg.dispatch/v1"
    assert set(payload) == {"schema", "platform", "meta", "entries"}
    rec = payload["entries"]["median|B0:m3:p18"]["backends"]["kernel"]
    assert rec == {"time_s": 0.002, "gate_err": 0.0,
                   "params": {"lanes": 4}}


def test_refusals():
    with pytest.raises(ValueError, match="schema"):
        DispatchTable.from_json({"schema": "repro.agg.dispatch/v1",
                                 "platform": "cuda"})
    with pytest.raises(TypeError, match="non-int"):
        DispatchTable("cpu").record("median", 1, 8, 10, "kernel", 0.001,
                                    lanes=4.0)
    payload = _table().to_json()
    payload["entries"]["median|B0:m3:p18"]["backends"]["kernel"][
        "params"]["lanes"] = 4.0
    with pytest.raises(ValueError, match="non-int"):
        DispatchTable.from_json(payload)
    # a card table holds B1's settings only: no plain PyTorch on the card
    for backend in ("reference", "sort"):
        with pytest.raises(ValueError, match="only the kernel backends"):
            DispatchTable("cuda").record("median", 1, 8, 10, backend, 0.001)
    payload = _table().to_json()
    payload["platform"] = "cuda"
    with pytest.raises(ValueError, match="only the kernel backends"):
        DispatchTable.from_json(payload)
    with pytest.raises(ValueError, match="cannot steer"):
        dispatch.set_table(_table(), platform="cuda")
    with pytest.raises(ValueError, match="needs the platform"):
        dispatch.set_table(dispatch.NO_TABLE)


def test_best_recomputed_per_record_and_buckets():
    t = DispatchTable("cpu")
    t.record("mean", 1, 8, 10, "kernel", 0.005, lanes=2)
    assert t.best("mean", 1, 8, 10) == ("kernel", {"lanes": 2})
    t.record("mean", 1, 8, 10, "reference", 0.001)
    assert t.best("mean", 1, 8, 10) == ("reference", {})
    assert bucket_of(320, 8, 10) == "B8:m3:p3"
    assert bucket_of(1, 8, 262144) == "B0:m3:p18"
    assert bucket_of(0, 1, 1) == "B0:m0:p0"
    assert bucket_of(1, 4, 620756992) == "B0:m2:p29"
    t = _table()
    assert t.best("median", 300, 9, 11) == ("reference", {})  # same bucket
    assert t.best("median", 300, 9, 16) is None               # crosses 2^4


# ------------------------------------------------------------ the policy

def test_decide_hit_unmeasured_and_no_table():
    # no table for the card (the committed cuda.json set aside)
    dispatch.set_table(dispatch.NO_TABLE, "cuda")
    dispatch.set_table(_table(), platform="cpu")
    assert dispatch.decide("median", 1, 8, 262144, platform="cpu") == \
        Decision("kernel", {"lanes": 4}, True, "table")
    d = dispatch.decide("median", 1, 8, 999999, platform="cpu")
    assert (d.backend, d.source, d.measured, d.params) == \
        ("reference", "fallback-unmeasured", False, {})
    d = dispatch.decide("masked:dcq", 1, 256, 7, platform="cpu")
    assert (d.backend, d.source) == ("sort", "fallback-unmeasured")
    # no table for the card: today's rule, the kernel (bisect when masked)
    for op, want in (("median", "kernel"), ("masked:median", "bisect")):
        d = dispatch.decide(op, 1, 8, 10, platform="cuda")
        assert (d.backend, d.source) == (want, "fallback-no-table")
    dispatch.set_table(None)
    for op, want in (("median", "reference"), ("masked:median", "sort")):
        d = dispatch.decide(op, 1, 8, 10, platform="cpu")
        assert (d.backend, d.source) == (want, "fallback-no-table")
    log = dispatch.decisions()
    assert log[("median", "B0:m3:p18", "table", "kernel")] == 1
    assert log[("masked:median", "B0:m3:p3", "fallback-no-table",
                "sort")] == 1
    assert sum(log.values()) == 7
    dispatch.reset_decisions()
    assert dispatch.decisions() == {}
    # a card table: its lanes where measured, else B1 at the planner's
    # lanes; never the reference
    dispatch.set_table(_card_table())
    assert dispatch.decide("median", 1, 8, 262144, platform="cuda") == \
        Decision("kernel", {"lanes": 4}, True, "table")
    assert dispatch.decide("masked:median", 1, 300, 5000,
                           platform="cuda") == \
        Decision("bisect", {"lanes": 32}, True, "table")
    for op, want in (("median", "kernel"), ("masked:dcq", "bisect")):
        assert dispatch.decide(op, 1, 8, 999999, platform="cuda") == \
            Decision(want, {}, False, "fallback-unmeasured")


def test_env_var_and_platform_mismatch(tmp_path, monkeypatch):
    t = _table()
    t.record("mean", 1, 8, 10, "reference", 0.001)
    monkeypatch.setenv(dispatch.ENV_VAR, str(t.save(tmp_path / "t.json")))
    dispatch.clear_cache()
    assert dispatch.decide("mean", 1, 8, 10, platform="cpu").source == \
        "table"
    # a cpu table never steers the card, nor a card table the CPU
    assert dispatch.decide("median", 320, 8, 10,
                           platform="cuda").source == "fallback-no-table"
    monkeypatch.setenv(dispatch.ENV_VAR, str(
        _card_table().save(tmp_path / "c.json")))
    dispatch.clear_cache()
    assert dispatch.decide("median", 320, 8, 10,
                           platform="cpu").source == "fallback-no-table"
    assert dispatch.load_table("cuda").platform == "cuda"
    # a path with no file is a mistake, not "no table"
    monkeypatch.setenv(dispatch.ENV_VAR, str(tmp_path / "typo.json"))
    dispatch.clear_cache()
    with pytest.raises(FileNotFoundError, match="typo.json"):
        dispatch.decide("median", 320, 8, 10, platform="cuda")


# ------------------------------------- the decision reaches every entry

def test_no_table_on_the_cpu_is_the_reference(calls):
    v = _v(3, 8, 10)
    for method in ("median", "dcq_mad", "trimmed", "mean"):
        got = agg.aggregate_batched(v, method=method)
        want = agg.aggregate_batched(v, method=method, backend="reference")
        assert torch.equal(got, want)
    assert torch.equal(agg.aggregate(v[0], method="median"),
                       agg.median_agg(v[0], 0))
    buf = _v(16, 5)
    assert torch.equal(agg.aggregate_masked(buf, 11, method="median"),
                       agg.aggregate_masked(buf, 11, method="median",
                                            backend="sort"))
    for a, b in zip(agg.median_mad_dcq(v), agg.median_mad_dcq(
            v, backend="reference")):
        assert torch.equal(a, b)
    assert calls == []
    assert {k[2:] for k in dispatch.decisions()} == \
        {("fallback-no-table", "reference"), ("fallback-no-table", "sort")}


def test_table_decision_reaches_every_entry_point(calls):
    t = DispatchTable("cpu")
    for op, shape in (("median", (1, 8, 6)), ("dcq_mad", (3, 8, 10)),
                      ("median_mad_dcq", (3, 8, 10)),
                      ("median", (1, 8, 12))):
        t.record(op, *shape, "reference", 0.002)
        t.record(op, *shape, "kernel", 0.001, lanes=2)
    t.record("masked:dcq_mad", 1, 16, 5, "sort", 0.002)
    t.record("masked:dcq_mad", 1, 16, 5, "bisect", 0.001, lanes=4)
    dispatch.set_table(t)
    v = _v(3, 8, 10)
    agg.aggregate(_v(8, 2, 3), method="median")              # (1, 8, 6)
    agg.aggregate_batched(v, method="dcq_mad")               # (3, 8, 10)
    agg.median_mad_dcq(v)
    agg.aggregate_masked(_v(16, 5), 11, method="dcq_mad")    # (1, 16, 5)
    wire_aggregate({"a": _v(8, 3, 4), "b": _v(8, 2)}, "median")
    assert calls == [("median", (8, 6), 2), ("dcq_mad", (3, 8, 10), 2),
                     ("median_mad_dcq", (3, 8, 10), 2),
                     ("dcq_mad", (11, 5), 4),
                     ("median", (8, 12), 2)]
    log = dispatch.decisions()
    assert log[("median", "B0:m3:p3", "table", "kernel")] == 1
    assert log[("masked:dcq_mad", "B0:m4:p2", "table", "bisect")] == 1
    # the leaf "b" (1, 8, 2) was never measured: the reference runs
    assert log[("median", "B0:m3:p1", "fallback-unmeasured",
                "reference")] == 1
    # a forced backend decides nothing
    n = sum(log.values())
    wire_aggregate(v, "median", backend="reference")
    wire_aggregate(_v(16, 5), "dcq_mad", fill=11, backend="sort")
    assert sum(dispatch.decisions().values()) == n and len(calls) == 5


def test_rules_without_a_choice_decide_nothing(calls):
    dispatch.set_table(_table())
    agg.aggregate(_v(8, 3), method="geomedian")
    agg.aggregate_masked(_v(16, 3), 9, method="trimmed")
    agg.aggregate_masked(_v(16, 3), 9, method="mean")
    assert dispatch.decisions() == {} and calls == []


def test_tuned_lanes_change_layout_not_result():
    v = _v(2, 20, 128)
    assert agg.kernel.lane_counts(20) == (4, 8, 16, 32)
    assert agg.kernel.lane_counts(300) == (32,)
    assert agg.kernel.ostat_plan(2, 20, 128).lanes == 32
    plan = agg.kernel.ostat_plan(2, 20, 128, lanes=4)
    assert (plan.lanes, plan.reg_rows, plan.slab) == (4, 8, False)
    for lanes in agg.kernel.lane_counts(20):
        assert torch.equal(agg.kernel.ostat(v, "median", lanes=lanes),
                           agg.kernel.ostat(v, "median"))
    for bad in (2, 3, 64):
        with pytest.raises(ValueError, match="lanes"):
            agg.kernel.ostat(v, "median", lanes=bad)
        with pytest.raises(ValueError, match="lanes"):
            agg.kernel.ostat_plan(2, 20, 128, lanes=bad)


# ------------------------------------------------------------ autotune

class _StubClock:
    """perf_counter stand-in advancing a fixed tick per call."""

    def __init__(self, tick=0.001):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t


def test_autotune_byte_stable_under_a_stub_clock():
    runs = []
    for _ in range(2):
        t = at.autotune(ops=["median", "dcq", "mean"],
                        shapes=((2, 8, 32), (1, 4, 64)), device="cpu",
                        reps=1, timer=_StubClock(), include_masked=False,
                        verbose=False)
        runs.append(json.dumps(t.to_json(), sort_keys=True))
    assert runs[0] == runs[1]
    payload = json.loads(runs[0])
    assert payload["platform"] == "cpu" and len(payload["entries"]) == 6
    entry = payload["entries"]["median|" + bucket_of(2, 8, 32)]
    assert set(entry["backends"]) == {"reference", "kernel"}
    # a tie keeps the incumbent: the reference on the CPU
    assert entry["best"] == "reference"
    kern = entry["backends"]["kernel"]
    assert "params" not in kern and kern["gate_err"] <= 5e-4
    assert payload["meta"]["rounds"] == at.ROUNDS


def test_a_challenger_wins_only_by_more_than_the_spread():
    """Each candidate's rounds take the listed seconds per call: the
    incumbent counts at its fastest round, a challenger at its slowest."""
    clock = [0.0]

    def timer():
        return clock[0]

    def cand(backend, lanes, rounds):
        it = iter(r for r in rounds for _ in range(2))   # warm-up + 1 rep

        def call():
            clock[0] += next(it)
        return (backend, {"lanes": lanes}, call, lambda: 0.0)

    for rounds_b, want in (((0.5, 0.5, 1.1), 1), ((0.5, 0.6, 0.9), 2)):
        t = DispatchTable("cuda")
        clock[0] = 0.0
        at._contest(t, "median", 1, 8, 10,
                    [cand("kernel", 1, (1.0, 1.2, 1.0)),
                     cand("kernel", 2, rounds_b),
                     cand("kernel", 4, (2.0, 2.0, 2.0))],
                    reps=1, rounds=3, timer=timer, tol=5e-4,
                    log=lambda *_: None)
        assert t.best("median", 1, 8, 10) == ("kernel", {"lanes": want})


def test_autotune_masked_records_both_backends():
    t = at.autotune(ops=[], shapes=(), device="cpu", reps=1,
                    timer=_StubClock(), masked_shapes=((16, 16),),
                    verbose=False)
    assert set(t.entries) == {f"masked:{r}|" + bucket_of(1, 16, 16)
                              for r in ("dcq", "dcq_mad", "median")}
    for entry in t.entries.values():
        assert set(entry["backends"]) == {"sort", "bisect"}
        assert entry["best"] == "sort"


def test_gate_err_is_the_999th_percentile():
    a = torch.zeros(2000)
    b = torch.zeros(2000)
    b[:2] = 1.0                        # 0.1% of the coordinates flip
    assert at._gate_err(a, b) == 0.0
    b[:3] = 1.0
    assert at._gate_err(a, b) == 1.0
    b[:3] = float("nan")               # a NaN counts as infinite
    assert at._gate_err(a, b) == float("inf")


def test_committed_card_table():
    path = dispatch.TABLE_DIR / "cuda.json"
    t = DispatchTable.load(path)
    assert t.platform == "cuda" and not (dispatch.TABLE_DIR
                                         / "cpu.json").exists()
    assert "H100" in t.meta["nvidia_smi"] and " W" in t.meta["nvidia_smi"]
    assert t.meta["reps"] >= 1 and t.meta["rounds"] >= 2
    assert t.meta["torch"] and t.meta["cuda"]
    for key, entry in t.entries.items():
        # one record per bucket: B1 with the lanes that won there
        (backend, rec), = entry["backends"].items()
        assert entry["best"] == backend in dispatch.KERNEL_BACKENDS, key
        assert set(rec["params"]) == {"lanes"}, key
        assert isinstance(rec["params"]["lanes"], int), key
        assert rec["gate_err"] <= 5e-4, key
    # every bucket of the default grid is measured for every tuned op
    ops = {k.split("|")[0] for k in t.entries}
    assert {"median", "dcq", "dcq_mad", "mean", "trimmed",
            "median_mad_dcq", "masked:median", "masked:dcq_mad"} <= ops
    for shape in at.DEFAULT_SHAPES:
        assert t.best("dcq_mad", *shape) is not None, shape
    for C, p in at.DEFAULT_MASKED_SHAPES:
        assert t.best("masked:dcq_mad", 1, C, p) is not None, (C, p)
