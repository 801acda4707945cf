"""The span readers on a synthetic trace and a synthetic ``obs.spans()``:
the division by the window's steps, the serve readers' "inside one span
and outside another" arithmetic, that the train readers' self times add
up to the steps' own intervals, and None where the program has no spans.
"""
import collections
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench.lib.harness import Run, load_module  # noqa: E402
from bench.lib.trace import WINDOW_SPAN, Trace  # noqa: E402

METRICS = ROOT / "bench" / "metrics"
TRAIN = ["model_ms.train", "noise_ms.train", "corrupt_ms.train",
         "widen_ms.train", "tree_ms.qn", "lbfgs_ms.qn", "adamw_ms.adamw",
         "unspanned_ms.train"]
SERVE = ["ingest_us.serve", "flush_host_us.serve", "sync_wait_us.serve"]


def _reader(name):
    return load_module(METRICS / f"{name}.py", name).read


def _run(steps, host=(), window=(0.0, 1000.0)):
    trace = Trace([], [(WINDOW_SPAN, *window), *host], window)
    return Run(ctx=None, cell=None, setup_s=0.0, window_s=1.0,
               steps=[{}] * steps, peak_window_bytes=0, trace=trace)


@pytest.fixture
def spans(monkeypatch):
    """Sets what ``obs.spans()`` returns."""
    from repro_torch import obs
    table = {}
    monkeypatch.setattr(obs, "spans", lambda: dict(table))
    return table


def test_train_readers_divide_by_the_window_steps(spans):
    spans.update({"repro.model": (32, 200.0), "repro.wire.noise": (24, 6.0),
                  "repro.wire.corrupt": (24, 4.0),
                  "repro.b1.widen": (24, 3.0), "repro.optim": (4, 8.0),
                  "repro.step": (2, 1.0)})
    run = _run(2)
    got = {n: _reader(n)(run) for n in TRAIN}
    assert got == {"model_ms.train": 100.0, "noise_ms.train": 3.0,
                   "corrupt_ms.train": 2.0, "widen_ms.train": 1.5,
                   "tree_ms.qn": None, "lbfgs_ms.qn": None,
                   "adamw_ms.adamw": 4.0, "unspanned_ms.train": 0.5}


def test_train_readers_add_up_to_the_steps_intervals(monkeypatch):
    """Two QN steps of injected device intervals (ms) through the
    program's own fold: every reader's value and B1's self time a step
    add up to the steps' mean interval."""
    from repro_torch import obs

    class Ev:
        def __init__(self, t):
            self.t = t

        def query(self):
            return True

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.t - self.t

    def node(name, t0, t1, *kids):
        n = obs._Node(name, Ev(t0))
        n.t1, n.kids = Ev(t1), list(kids)
        return n

    def step(t):
        b1 = node("repro.b1", t + 52, t + 66)
        tree = node("repro.tree", t + 5, t + 95,
                    node("repro.model", t + 6, t + 30),
                    node("repro.wire.noise", t + 31, t + 37),
                    node("repro.wire.corrupt", t + 38, t + 45),
                    node("repro.b1.widen", t + 50, t + 70, b1),
                    node("repro.lbfgs", t + 75, t + 81))
        return node("repro.step", t, t + 100, tree)
    monkeypatch.setattr(obs, "_pending", collections.deque([step(0),
                                                            step(130)]))
    monkeypatch.setattr(obs, "_totals", {})
    monkeypatch.setattr(obs, "_pool", [])
    run = _run(2)
    total = sum(_reader(n)(run) or 0.0 for n in TRAIN)
    b1 = obs.spans()["repro.b1"][1] / 2
    assert total + b1 == pytest.approx(100.0)
    assert _reader("tree_ms.qn")(run) == pytest.approx(90 - 24 - 6 - 7
                                                        - 20 - 6)


def test_serve_readers_take_inside_less_outside_per_round():
    host = [("repro.serve.submit", 10.0, 110.0),
            ("repro.serve.flush", 60.0, 100.0),
            ("repro.serve.sync", 80.0, 95.0),
            ("aten::view", 20.0, 21.0),
            ("repro.serve.submit", 200.0, 290.0),
            ("repro.serve.flush", 250.0, 285.0),
            ("repro.serve.sync", 270.0, 280.0),
            # outside the window: not counted
            ("repro.serve.submit", 1100.0, 1200.0)]
    run = _run(2, host)
    got = {n: _reader(n)(run) for n in SERVE}
    assert got == {"ingest_us.serve": (60.0 + 55.0) / 2,
                   "flush_host_us.serve": (25.0 + 25.0) / 2,
                   "sync_wait_us.serve": (15.0 + 10.0) / 2}
    # the three split the submit span's time
    assert sum(got.values()) == (100.0 + 90.0) / 2


def test_readers_read_nothing_without_spans(monkeypatch, spans):
    run = _run(2, [("aten::view", 20.0, 21.0)])
    assert all(_reader(n)(run) is None for n in TRAIN + SERVE)
    spans["repro.model"] = (16, 10.0)
    # a program without repro_torch.obs (the import fails)
    import repro_torch
    with monkeypatch.context() as m:
        m.delattr(repro_torch, "obs")
        m.setitem(sys.modules, "repro_torch.obs", None)
        assert _reader("model_ms.train")(run) is None
    # an untraced run, and a span counted but not timed on a card
    untraced = Run(ctx=None, cell=None, setup_s=0.0, window_s=1.0,
                   steps=[{}], peak_window_bytes=0)
    assert _reader("model_ms.train")(untraced) is None
    spans["repro.model"] = (16, None)
    assert _reader("model_ms.train")(run) is None
