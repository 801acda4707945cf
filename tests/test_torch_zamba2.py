"""Zamba2 as published in the port (``Zamba2Config``,
``zamba2-7b-instruct``) against the plain reference of
tests/zamba2_plain.py, on the CPU, at the config's test size
(``Zamba2Config.reduced``: d 64, Mamba2 at 2 groups of state 8 with heads
of 16 and chunk 16, 4 attention heads of 2d / 4, adapter rank 8, six
layers with four insertions over the two blocks, so each block is used
twice and its gradient sums over two insertions, each with its own
adapter) at S = 37, not a multiple of the chunk.

Tolerances. The reference runs in float64 on the port's float32
parameters. ``Model.loss`` within 1e-6 relative; each leaf's gradient
within 2e-4 of that leaf's largest reference entry: float32 rounding
through six layers and four insertions reaches ~6e-5 of a leaf's scale,
as much in the plain reference computed in float32 as in the port (over
four seeds, the worst leaf 3.5e-5 to 6.0e-5 for the port and 2.9e-5 to
6.2e-5 for the plain float32), mostly where an RMS norm divides by the
small embedding (0.02) and in the scan's ``a_log``; a leaf 1e-5 from the
float64 gradient is out of reach in float32 at this depth. Half the
heads' ``dt_bias`` sit 8 below zero so that the dt floor binds. The
reference's scan against the recurrence step by step within 1e-5. The
full model's and the benchmark's 12-layer cut's parameter counts
exactly, on meta. On a bfloat16 model the scan and the
gated norm run in float32. The port's ``zamba2-7b`` and the registry
``ARCHS`` stay the reference's.
"""
import dataclasses

import pytest
import torch

import zamba2_plain as plain
from repro_torch import obs
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import Zamba2Config
from repro_torch.core.transport import leaf_paths, tree_leaves
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ARCH = "zamba2-7b-instruct"
S = 37


def _cfg():
    return get_config(ARCH, reduced=True)


def _model(remat=False, seed=0):
    """The test-size model with every leaf off its constant init (norms,
    conv bias, a_log, dt_bias, d_skip), so each one matters."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(seed)
    model = Model(cfg, device="cpu", generator=g, remat=remat)
    with torch.no_grad():
        for path, x in zip(leaf_paths(model.params()),
                           tree_leaves(model.params())):
            name = path.rsplit("/", 1)[-1]
            noise = torch.randn(x.shape, generator=g)
            if name.startswith("norm") or name == "d_skip":
                x.add_(0.2 * noise)
            elif name in ("conv_b", "dt_bias", "a_log"):
                x.add_(0.3 * noise)
        # below the floor: softplus(dt - 8) is ~3e-4 < dt_min = 1e-3
        model.params()["layers"]["ssm"]["dt_bias"][:, ::2] -= 8
    return model


def _batch(seed=1, rows=2):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, _cfg().vocab, (rows, S + 1), generator=g)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


def test_plain_scan_matches_the_recurrence():
    g = torch.Generator().manual_seed(2)
    b, h, p, n = 2, 4, 8, 6
    x = torch.randn(b, S, h, p, generator=g)
    dt = torch.rand(b, S, h, generator=g) * 0.5 + 0.01
    A = -torch.rand(h, generator=g) * 2
    B, C = (torch.randn(b, S, h, n, generator=g) for _ in range(2))
    want = plain.ssd_sequential(x, dt, A, B, C)
    for chunk in (16, 37, 64):
        got = plain.ssd_minimal(x, dt, A, B, C, chunk)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_port_scan_at_two_groups_matches_the_recurrence():
    """``ssd_chunked`` with heads 0-3 on group 0 and 4-7 on group 1."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(3)
    b, H, p, G, n = 2, 8, 16, 2, 8
    x = torch.randn(b, S, H, p, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.5 + 0.01
    a_log = torch.randn(H, generator=g) * 0.5
    B, C = (torch.randn(b, S, G, n, generator=g) for _ in range(2))
    got = tssm.ssd_chunked(x, dt, a_log, B, C, cfg)
    want = plain.ssd_sequential(x, dt, -torch.exp(a_log),
                                B.repeat_interleave(H // G, dim=2),
                                C.repeat_interleave(H // G, dim=2))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_scan_runs_in_float32_on_a_bf16_model(monkeypatch):
    """On a bfloat16 model each Mamba2 mixer's scan reads and returns
    float32, and so does its gated group norm (the benchmark
    configuration's ``assumed.scan``). The benchmark's check cannot tell a
    scan in bfloat16 from the program's own bfloat16 rounding elsewhere,
    so this test holds the precision."""
    cfg = dataclasses.replace(_cfg(), dtype="bfloat16")
    seen = []
    scan, norm = tssm.ssd_chunked, tssm._group_rms

    def spy_scan(x, dt, a_log, B, C, c):
        y = scan(x, dt, a_log, B, C, c)
        seen.append({t.dtype for t in (x, dt, a_log, B, C, y)})
        return y

    def spy_norm(y, w, groups, eps):
        seen.append({y.dtype})
        return norm(y, w, groups, eps)
    monkeypatch.setattr(tssm, "ssd_chunked", spy_scan)
    monkeypatch.setattr(tssm, "_group_rms", spy_norm)
    loss, _ = Model(cfg, device="cpu").loss(_batch())
    assert torch.isfinite(loss)
    assert len(seen) == 2 * cfg.n_layers
    assert all(s == {torch.float32} for s in seen)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_leaf_gradient_match_the_plain_model(remat):
    model = _model(remat=remat)
    batch = _batch()
    params = model.params()
    paths, leaves = leaf_paths(params), tree_leaves(params)
    loss, _ = model.loss(batch)
    got = torch.autograd.grad(loss, leaves)
    P = {p: x.detach().double().requires_grad_() for p, x in
         zip(paths, leaves)}
    ref = plain.loss(P, batch["tokens"], batch["labels"], _cfg())
    want = torch.autograd.grad(ref, list(P.values()))
    assert float(loss.detach()) == pytest.approx(float(ref.detach()),
                                                 rel=1e-6)
    assert "lm_head" not in paths and len(paths) == 22
    for path, a, b in zip(paths, got, want):
        scale = float(b.abs().max())
        assert scale > 0, path
        assert float((a.double() - b).abs().max()) <= 2e-4 * scale, path


def test_each_block_and_adapter_is_used_by_its_insertions():
    """Blocks alternate over the four insertions: a gradient that only
    insertions 0 and 2 reach flows into block 0 alone."""
    model = _model()
    params = model.params()
    loss, _ = model.loss(_batch())
    ins = params["insertions"]
    blocks = params["shared_blocks"]
    ga, gq = torch.autograd.grad(loss, [ins["adapter_b"],
                                        blocks["attn"]["w_q"]])
    assert all(float(ga[j].abs().max()) > 0 for j in range(4))
    assert all(float(gq[b].abs().max()) > 0 for b in range(2))


def test_one_qn_step_and_one_adamw_step_are_finite():
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import (QNTrainConfig, TrainConfig,
                                           make_qn_train_step,
                                           make_train_step)
    model = _model()
    params = model.params()
    before = [x.detach().clone() for x in tree_leaves(params)]
    batch = _batch(rows=8)
    mask = torch.tensor([True, False, False, False])
    key = torch.Generator().manual_seed(5)
    step = make_qn_train_step(model, QNTrainConfig(
        n_machines=4, attack="signflip",
        protocol=TreeProtocolConfig(hist=1, eps=1e6)))
    mem = LBFGSMemory.init_like(1, params, machines=4)
    params, mem, met = step(params, mem, batch, key, mask)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))
    assert any(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(params)))
    opt = AdamW(lr=1e-3)
    astep = make_train_step(model, opt, TrainConfig(
        n_machines=4, agg=GradAggConfig(method="dcq_mad",
                                        attack="signflip", dp_sigma=1e-5)))
    params, _, met = astep(params, opt.init(params), batch, key, mask)
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])


def test_full_and_cut_counts_on_meta():
    """The benchmark's cut is published layers 17-28: insertions 2 (block
    0) and 3 (block 1), at layers 0 and 6 of the cut."""
    full = get_config(ARCH)
    kept = [i - 17 for i in full.hybrid_layers if 17 <= i < 29]
    assert kept == [0, 6] and full.hybrid_layers.index(17) == 2
    cut = dataclasses.replace(full, n_layers=12, hybrid_layers=tuple(kept))
    for cfg, want in ((full, 7_356_749_648), (cut, 1_757_853_120)):
        model = Model(cfg, device="meta")
        got = sum(x.numel() for x in tree_leaves(model.params()))
        assert got == want == plain.n_params(cfg)
    f32 = [p for p, x in zip(leaf_paths(model.params()),
                             tree_leaves(model.params()))
           if x.dtype == torch.float32]
    assert f32 == ["layers/ssm/a_log", "layers/ssm/d_skip",
                   "layers/ssm/dt_bias"]


def test_the_reference_catalogue_is_unchanged():
    assert len(ARCHS) == 10 and ARCH not in ARCHS
    assert isinstance(get_config(ARCH), Zamba2Config)
    old = get_config("zamba2-7b")
    assert type(old) is not Zamba2Config and old.attn_every == 6
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("zamba2-7b-base")
    assert dataclasses.asdict(_cfg())["hybrid_layers"] == (0, 2, 3, 5)


def _profiled(model, batch, monkeypatch):
    """Runs a loss and its gradient under a CPU profiler, recording the
    span open at each call of the scan (forward and recompute) and at its
    gradient; returns (the span totals, those names)."""
    seen = []
    orig = tssm.ssd_chunked

    def scan(*a, **kw):
        seen.append(("call", obs._stack[-1].name if obs._stack else None))
        y = orig(*a, **kw)
        if y.requires_grad:
            y.register_hook(lambda g: seen.append(
                ("grad", obs._stack[-1].name if obs._stack else None)))
        return y
    monkeypatch.setattr(tssm, "ssd_chunked", scan)
    from torch.profiler import ProfilerActivity, profile
    obs.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("repro.model"):
            loss, _ = model.loss(batch)
            torch.autograd.grad(loss, tree_leaves(model.params()))
    assert not obs._stack
    return obs.spans(), seen


@pytest.mark.parametrize("remat", [False, True])
def test_spans_cover_forward_recompute_and_backward(remat, monkeypatch):
    """Each Mamba2 layer's scan runs, and its gradient is taken, inside
    ``repro.ssm``: forward, recompute and backward; each insertion opens
    ``repro.shared`` once forward and once backward."""
    spans, seen = _profiled(_model(remat=remat), _batch(), monkeypatch)
    n = _cfg().n_layers
    assert spans["repro.ssm"][0] == 2 * n
    assert spans["repro.shared"][0] == 2 * len(_cfg().hybrid_layers)
    calls = [s for kind, s in seen if kind == "call"]
    grads = [s for kind, s in seen if kind == "grad"]
    assert len(calls) == (2 * n if remat else n) and len(grads) == n
    assert set(calls) == set(grads) == {"repro.ssm"}


def test_the_dense_path_opens_neither_span(monkeypatch):
    cfg = get_config("glm4-9b", reduced=True)
    model = Model(cfg, device="cpu", remat=True)
    spans, _ = _profiled(model, {"tokens": _batch()["tokens"] % cfg.vocab,
                                 "labels": _batch()["labels"] % cfg.vocab},
                         monkeypatch)
    assert set(spans) == {"repro.model"}
