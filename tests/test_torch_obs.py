"""``repro_torch.obs``: spans that cost a flag read while no profiler
records, and that a profiler sees as host ``cpu_op`` events (never as a
``user_annotation``, which kineto gives a device-side track); the fold of
nested spans into self times, on injected intervals; and the span counts
of one QN step, one AdamW step and one serve round on the CPU (B1's spans
sit on the card's path and are counted there).
"""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import TreeProtocolConfig
from repro_torch.core import dp
from repro_torch.core.bfgs import LBFGSMemory
from repro_torch.core.transport import tree_leaves
from repro_torch.data.lm import make_batch
from repro_torch.dist.grad_agg import GradAggConfig
from repro_torch.models.model import Model
from repro_torch.serve.service import AggregationService, ServeConfig
from repro_torch.train import trainer
from repro_torch.train.optimizer import AdamW
from torch_threads import share_the_cores  # noqa: F401 (autouse)

M = 4


@pytest.fixture(autouse=True)
def fresh_totals():
    obs.reset()
    yield
    obs.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_without_a_profiler_span_is_the_shared_noop_and_records_nothing():
    assert obs.span("repro.step") is obs.span("repro.model")
    with obs.span("repro.step"):
        with obs.span("repro.model"):
            torch.ones(3).sum()
    assert obs.spans() == {}


def test_spans_are_cpu_op_host_events_and_not_user_annotations():
    with _cpu_profile() as prof:
        with obs.span("repro.step"):
            with obs.span("repro.model"):
                torch.ones(3).sum()
            with obs.span("repro.model"):
                torch.ones(3).sum()
    seen = [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith("repro.")]
    assert sorted(e.name() for e in seen) == ["repro.model", "repro.model",
                                              "repro.step"]
    for e in seen:
        assert e.activity_type() == "cpu_op"
        assert not e.is_user_annotation()
        assert e.device_type() == torch.autograd.DeviceType.CPU
    # no card: counted, not timed
    assert obs.spans() == {"repro.step": (1, None), "repro.model": (2, None)}
    # the profiler stopped: the spans are off again
    assert obs.span("repro.step") is obs.span("repro.tree")


class _Event:
    """A stand-in for ``torch.cuda.Event`` at a fixed time (ms)."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return end.t - self.t


def _node(name, t0, t1, kids=(), done=True):
    n = obs._Node(name, _Event(t0))
    n.t1 = _Event(t1, done)
    n.kids = list(kids)
    return n


@pytest.fixture
def injected(monkeypatch):
    monkeypatch.setattr(obs, "_pending", collections.deque())
    monkeypatch.setattr(obs, "_totals", {})
    monkeypatch.setattr(obs, "_pool", [])
    return obs


def test_self_time_is_the_interval_less_the_direct_children(injected):
    b1 = _node("repro.b1", 55, 65)
    widen = _node("repro.b1.widen", 50, 70, [b1])
    tree = _node("repro.tree", 45, 95, [widen, _node("repro.lbfgs", 80, 90)])
    step1 = _node("repro.step", 0, 100, [_node("repro.model", 10, 40), tree])
    step2 = _node("repro.step", 100, 130, [_node("repro.model", 105, 125)])
    injected._pending.extend([step1, step2])
    got = injected.spans()
    assert got == {"repro.step": (2, 30.0), "repro.model": (2, 50.0),
                   "repro.tree": (1, 20.0), "repro.b1.widen": (1, 10.0),
                   "repro.b1": (1, 10.0), "repro.lbfgs": (1, 10.0)}
    # the self times of a step's spans add up to the steps' intervals
    assert sum(ms for _, ms in got.values()) == 130.0
    # every event went back to the pool
    assert len(injected._pool) == 2 * 8


def test_the_fold_waits_for_nothing_and_keeps_the_order(injected):
    running = _node("repro.step", 20, 30, done=False)
    injected._pending.extend([_node("repro.step", 0, 10), running,
                              _node("repro.step", 40, 45)])
    injected._fold_pending(wait=False)
    assert injected._totals == {"repro.step": [1, 10.0]}
    assert list(injected._pending)[0] is running
    assert injected.spans() == {"repro.step": (3, 25.0)}
    assert not injected._pending


def test_only_a_timed_root_and_the_spans_inside_it_record_events(
        injected, monkeypatch):
    clock = iter(range(100))
    monkeypatch.setattr(obs, "_event", lambda: _Event(next(clock)))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with _cpu_profile():
        with obs.span("repro.serve.flush"):
            with obs.span("repro.b1", timed=True):
                pass
        with obs.span("repro.step", timed=True):
            with obs.span("repro.b1"):
                pass
    # the untimed round drew no event; the step's two spans drew four
    assert next(clock) == 4
    assert obs.spans() == {"repro.serve.flush": (1, None),
                           "repro.b1": (2, 1.0), "repro.step": (1, 2.0)}


def _tiny_model():
    cfg = get_config("glm4-9b", reduced=True)
    gen = torch.Generator().manual_seed(7)
    return cfg, gen, Model(cfg, device="cpu", generator=gen, remat=True)


def test_span_counts_of_a_qn_step():
    cfg, gen, model = _tiny_model()
    step = trainer.make_qn_train_step(model, trainer.QNTrainConfig(
        n_machines=M, attack="signflip",
        protocol=TreeProtocolConfig(hist=1, eps=1.0)))
    params = model.params()
    leaves = len(tree_leaves(params))
    mem = LBFGSMemory.init_like(1, params, machines=M)
    sigmas = {name: 1e-3 for name in dp.TREE_TRANSMISSIONS}
    batch = make_batch(gen, cfg, 2 * M, 16)
    with _cpu_profile():
        step(params, mem, batch, torch.Generator().manual_seed(1),
             torch.arange(M) < 1, sigmas=sigmas)
    counts = {name: n for name, (n, _) in obs.spans().items()}
    assert counts == {"repro.step": 1, "repro.tree": 1, "repro.model": 16,
                      "repro.wire.noise": 5 * leaves,
                      "repro.wire.corrupt": 5 * leaves,
                      "repro.lbfgs": 2 * 2 * M}


def test_span_counts_of_an_adamw_step():
    cfg, gen, model = _tiny_model()
    opt = AdamW()
    step = trainer.make_train_step(model, opt, trainer.TrainConfig(
        n_machines=M, agg=GradAggConfig(method="dcq_mad", attack="signflip",
                                        dp_eps=1.0, dp_n=1000)))
    params = model.params()
    leaves = len(tree_leaves(params))
    batch = make_batch(gen, cfg, M, 16)
    with _cpu_profile():
        step(params, opt.init(params), batch,
             torch.Generator().manual_seed(1), torch.arange(M) < 1)
    counts = {name: n for name, (n, _) in obs.spans().items()}
    assert counts == {"repro.step": 1, "repro.model": M,
                      "repro.wire.noise": leaves,
                      "repro.wire.corrupt": leaves, "repro.optim": 2}


def test_span_counts_of_a_serve_round():
    cap = 64
    svc = AggregationService(torch.zeros(10), ServeConfig(
        method="dcq_mad", capacity=cap, eps=1.0, ingest_block=16),
        device="cpu")
    updates = torch.randn((cap, 10), generator=torch.Generator()
                          .manual_seed(3))
    with _cpu_profile():
        svc.submit_many(updates)
    assert svc.round_idx == 1
    # the flush inside submit_many; its wait for the card is CUDA's only
    assert obs.spans() == {"repro.serve.submit": (1, None),
                           "repro.serve.flush": (1, None)}
