"""Each plain reference under ``bench/reference`` against ``repro_torch`` on
the CPU at a test size. The test imports both; the references import
nothing of the program."""
import json
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))

from bench.lib import glm4_cell as G  # noqa: E402
from bench.reference import agg, glm4  # noqa: E402
from bench.reference.adamw_wire import AdamWReference  # noqa: E402
from bench.reference.qn_step import QNReference  # noqa: E402
from bench.reference.serve_flush import round_seed, round_step  # noqa: E402

DATA = ROOT / "bench" / "tests" / "data"
CFG = json.loads((DATA / "configs" / "tiny-glm4-f32.json").read_text())


def _close(a, b, tol):
    return all(float((a[k] - b[k]).abs().max()) <= tol * max(
        1.0, float(b[k].abs().max())) for k in b)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8, 9, 33])
def test_dcq_mad_matches_the_programs_plain_rule(m):
    from repro_torch.agg.reference import dcq_mad_reference
    v = torch.randn(m, 5000, generator=torch.Generator().manual_seed(m))
    assert torch.equal(agg.sorted_rows(v), v.sort(dim=0).values)
    assert float((agg.dcq_mad(v) - dcq_mad_reference(v)).abs().max()) \
        < 1e-6


def test_glm4_loss_and_gradient_match_the_model():
    from repro_torch.core.transport import tree_leaves
    model, params, paths = G.build_model(CFG, 3, "cpu", remat=False)
    batch = G.batches_for(3, "t", 1, 2, 16, CFG["vocab"], "cpu")[0]
    leaves = tree_leaves(params)
    loss, _ = model.loss(batch)
    want = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    P = glm4.make_params(CFG, G.weights_seed(3), "cpu")
    ref_loss, got = glm4.loss_and_grads(P, batch["tokens"], batch["labels"],
                                        CFG)
    assert float(ref_loss) == pytest.approx(float(loss.detach()), rel=1e-6)
    assert _close(got, want, 1e-5)


def test_glm4_control_moves_the_gradient():
    P = glm4.make_params(CFG, G.weights_seed(3), "cpu")
    b = G.batches_for(3, "t", 1, 2, 16, CFG["vocab"], "cpu")[0]
    _, g = glm4.loss_and_grads(P, b["tokens"], b["labels"], CFG)
    _, g8 = glm4.loss_and_grads(P, b["tokens"], b["labels"], CFG, "fp8")
    assert not _close(g8, g, 1e-3)


def _weights():
    return glm4.make_params(CFG, G.weights_seed(4), "cpu")


def test_qn_reference_follows_the_programs_step():
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core.bfgs import LBFGSMemory
    from repro_torch.core.transport import (tree_flatten, tree_leaves,
                                            tree_unflatten)
    from repro_torch.train.trainer import QNTrainConfig, make_qn_train_step
    model, params, paths = G.build_model(CFG, 4, "cpu", remat=True)
    sig = {p: 1e-5 for p in paths}
    step = make_qn_train_step(model, QNTrainConfig(
        n_machines=4, attack="signflip",
        protocol=TreeProtocolConfig(hist=1, eps=1.0)))
    mem = LBFGSMemory.init_like(1, params, machines=4)
    mask = torch.tensor([True, False, False, False])
    td = tree_flatten(params)[1]
    sigmas = {n: tree_unflatten(td, [sig[p] for p in paths]) for n in
              ("R1 theta", "R2 grad", "R3 newton-dir", "R4 grad-diff",
               "R5 bfgs-dir")}
    batches = G.batches_for(4, "q", 2, 8, 16, CFG["vocab"], "cpu")
    key = torch.Generator().manual_seed(11)
    P = _weights()
    ref = QNReference(CFG, {"lr": 0.5, "local_lr": 0.1, "local_steps": 1,
                            "hist": 1, "K": 10}, sig, [0], 4,
                      torch.Generator().manual_seed(11))
    pushes = [0] * 4
    for b in batches:
        params, mem, met = step(params, mem, b, key, mask, sigmas=sigmas)
        out = ref.step(P, {k: v.reshape(4, -1, 16) for k, v in b.items()})
        assert out["loss"] == pytest.approx(float(met["loss"]), rel=1e-5)
        pushes = [n + (y is not None) for n, y in zip(pushes, out["y"])]
    got = dict(zip(paths, tree_leaves(params)))
    assert _close(P, {k: v.detach() for k, v in got.items()}, 1e-3)
    assert mem.count.tolist() == pushes


def test_adamw_reference_follows_the_programs_step():
    from repro_torch.core.transport import tree_leaves
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainConfig, make_train_step
    model, params, paths = G.build_model(CFG, 4, "cpu", remat=True)
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt, TrainConfig(
        n_machines=4, agg=GradAggConfig(method="dcq_mad", attack="signflip",
                                        dp_sigma=1e-5)))
    state = opt.init(params)
    mask = torch.tensor([True, False, False, False])
    key = torch.Generator().manual_seed(12)
    o = {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "grad_clip": 1.0}
    ref = AdamWReference(CFG, o, {p: 1e-5 for p in paths}, [0], 4,
                         torch.Generator().manual_seed(12), 10)
    P = _weights()
    for b in G.batches_for(4, "a", 3, 4, 16, CFG["vocab"], "cpu"):
        params, state, met = step(params, state, b, key, mask)
        out = ref.step(P, {k: v.reshape(4, -1, 16) for k, v in b.items()})
        assert out["loss"] == pytest.approx(float(met["loss"]), rel=1e-5)
    # AdamW's first steps move by about lr times the gradient's sign, so
    # a coordinate whose gradient is nought to rounding may move either
    # way: the leaves' changes are held by their norms, as the cell holds
    # them
    got = dict(zip(paths, tree_leaves(params)))
    ref_change = G.change_norms(CFG, 4, P, "cpu")
    prog_change = G.change_norms(CFG, 4, got, "cpu")
    assert max(abs(prog_change[k] - ref_change[k]) / ref_change[k]
               for k in ref_change) < 1e-3


def test_serve_round_matches_the_service():
    from repro_torch.core.keys import stream_seed
    from repro_torch.serve.service import AggregationService, ServeConfig
    g = torch.Generator().manual_seed(5)
    ups = torch.randn(3, 256, 10, generator=g)
    theta = torch.randn(10, generator=g)
    svc = AggregationService(theta.clone(), ServeConfig(
        method="dcq_mad", capacity=256, eps=1.0, dp_n=100, lr=0.1,
        ingest_block=64, seed=77), device="cpu")
    from bench.lib.dp import sigma
    s = sigma(10, 100, 2.0, 1.0, 1e-6)
    for r in range(3):
        assert round_seed(77, r) == stream_seed(77, "serve", r)
        before = svc.theta.clone()
        svc.submit_many(ups[r])
        move, scale = round_step(ups[r], 77, r, s, 0.1)
        gap = (svc.theta.double() - before.double() - move).abs() \
            / (0.1 * scale)
        assert float(gap.max()) < 1e-4
    assert math.isfinite(float(svc.theta.sum()))


def _dp_workloads():
    for d in (ROOT / "bench" / "workloads", DATA / "workloads"):
        for p in sorted(d.glob("*.json")):
            w = json.loads(p.read_text())
            if "sigmas" in w.get("dp", {}):
                yield pytest.param(p, id=p.stem)


@pytest.mark.parametrize("path", list(_dp_workloads()))
def test_the_programs_calibration_gives_the_workloads_sigmas(path):
    """The sigmas the reference reads from a workload file are the ones
    the program calibrates for itself from the same budget: the protocol's
    for each of its five transmissions, the gradient wire's per leaf."""
    from repro_torch.core.dp import calibrate_tree_sigmas
    from repro_torch.core.transport import leaf_paths, tree_leaves, tree_map
    from repro_torch.dist.grad_agg import GradAggConfig, calibrate_leaf_sigmas
    from repro_torch.models.model import Model
    w = json.loads(path.read_text())
    cdir = path.parent.parent / "configs"
    c = json.loads((cdir / f"{w['config']}.json").read_text())
    dp = w["dp"]
    params = Model(G.model_config(c), device="meta").params()
    paths = leaf_paths(params)
    if w["driver"] == "qn_step":
        trees = calibrate_tree_sigmas(
            params, dp["n"], dp["eps"], dp["delta"],
            (dp["gamma"],) * dp["transmissions"]).values()
    else:
        stacked = tree_map(lambda x: x.expand((w["machines"],) + x.shape),
                           params)
        trees = [calibrate_leaf_sigmas(stacked, GradAggConfig(
            dp_eps=dp["eps"], dp_delta=dp["delta"], dp_gamma=dp["gamma"],
            dp_n=dp["n"]))]
    for tree in trees:
        got = dict(zip(paths, tree_leaves(tree)))
        assert got == pytest.approx(dp["sigmas"], rel=1e-12)
