"""The Zamba2 cell (``drivers/zamba2_qn_step.py``, ``reference/zamba2.py``)
on the CPU at a test size (``data/configs/tiny-zamba2.json``: the
published form at d 64, four layers, two insertions over the two blocks,
f32): the reference's scan against the recurrence step by step, its loss
and gradient against the program's ``Zamba2Config`` model, its leaf
specs against the program's tree on meta at the cell's own
configuration, the workloads' sigmas against the program's calibration,
the control and each planted fault failing a limit where a sound run
passes, and a program without ``Zamba2Config`` refused at once. The
references import nothing of the program; this test imports both."""
import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench.lib import glm4_cell as G  # noqa: E402
from bench.lib.harness import (Context, load_json, load_module,  # noqa: E402
                               run_cell)
from bench.reference import zamba2 as Z  # noqa: E402

DATA = ROOT / "bench" / "tests" / "data"
CFG = load_json(DATA / "configs" / "tiny-zamba2.json")
DRV = load_module(ROOT / "bench" / "drivers" / "zamba2_qn_step.py",
                  "zamba2_qn_step")
SEED = 2 ** 33 + 12345
CELL = "tiny-zamba2-qn"
FAULTS = ("control", "half", "alter", "nonoise", "sigma2", "noembed",
          "noadapter")


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


def test_the_reference_scan_matches_the_recurrence():
    g = torch.Generator().manual_seed(1)
    b, l, h, p, n = 2, 37, 4, 8, 6
    x = torch.randn(b, l, h, p, generator=g)
    dt = torch.rand(b, l, h, generator=g) * 0.5 + 0.01
    A = -torch.rand(h, generator=g) * 2
    B, C = (torch.randn(b, l, h, n, generator=g) for _ in range(2))
    s = torch.zeros(b, h, p, n)
    want = []
    for t in range(l):
        s = s * torch.exp(dt[:, t] * A)[..., None, None] \
            + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, :, None]
        want.append(torch.einsum("bhpn,bhn->bhp", s, C[:, t]))
    want = torch.stack(want, dim=1)
    got = Z.ssd(x, dt, A, B, C, 16)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_the_reference_loss_and_gradient_match_the_program():
    """f32 on both sides; each leaf within 2e-4 of its largest entry (f32
    rounding through the layers reaches ~6e-5 of a leaf's scale in this
    model: tests/test_torch_zamba2.py)."""
    from repro_torch.core.transport import tree_leaves
    model, params, paths = DRV.build_model(CFG, DRV.program_config(CFG), 3,
                                           "cpu", remat=True)
    batch = G.batches_for(3, "t", 1, 2, 24, CFG["vocab_size"], "cpu")[0]
    loss, _ = model.loss(batch)
    want = dict(zip(paths, torch.autograd.grad(loss, tree_leaves(params))))
    P = Z.make_params(CFG, G.weights_seed(3), "cpu")
    ref_loss, got = Z.loss_and_grads(P, batch["tokens"], batch["labels"],
                                     CFG)
    assert float(ref_loss) == pytest.approx(float(loss.detach()), rel=1e-6)
    for k, b in want.items():
        assert float((got[k] - b).abs().max()) <= 2e-4 * float(
            b.abs().max()), k


def test_leaf_specs_are_the_programs_tree_at_the_cells_size():
    from repro_torch.core.transport import leaf_paths, tree_leaves
    from repro_torch.models.model import Model
    c = load_json(ROOT / "bench" / "configs" / "zamba2-7b-12l.json")
    tree = Model(DRV.program_config(c), device="meta").params()
    got = [(p, tuple(x.shape), x.dtype)
           for p, x in zip(leaf_paths(tree), tree_leaves(tree))]
    assert got == [(p, s, Z.leaf_dtype(c, p)) for p, s, _ in Z.leaf_specs(c)]
    assert sum(math.prod(s) for _, s, _ in got) == c["n_params"] \
        == 1_757_853_120


@pytest.mark.parametrize("path", [
    ROOT / "bench" / "workloads" / "zamba2-qn-step.json",
    DATA / "workloads" / "tiny-zamba2-qn.json"], ids=lambda p: p.stem)
def test_the_programs_calibration_gives_the_workloads_sigmas(path):
    """The workload's top-level ``sigmas`` are the protocol's own for each
    of its five transmissions."""
    from repro_torch.core.dp import calibrate_tree_sigmas
    from repro_torch.core.transport import leaf_paths, tree_leaves
    from repro_torch.models.model import Model
    w = json.loads(path.read_text())
    c = json.loads((path.parent.parent / "configs"
                    / f"{w['config']}.json").read_text())
    dp = w["dp"]
    params = Model(DRV.program_config(c), device="meta").params()
    trees = calibrate_tree_sigmas(params, dp["n"], dp["eps"], dp["delta"],
                                  (dp["gamma"],) * dp["transmissions"])
    for tree in trees.values():
        got = dict(zip(leaf_paths(params), tree_leaves(tree)))
        assert got == pytest.approx(w["sigmas"], rel=1e-12)


def test_b1_prices_the_f32_leaves_at_four_bytes():
    """At the cell's own configuration: bf16 leaves at 2 bytes, the three
    f32 leaves at 4, five aggregations each a step."""
    w = load_json(ROOT / "bench" / "workloads" / "zamba2-qn-step.json")
    c = load_json(ROOT / "bench" / "configs" / "zamba2-7b-12l.json")
    cell = DRV.build(Context(ROOT, "zamba2-qn-step", w, c, SEED, "cpu"))
    got = cell.b1_launches()
    specs = Z.leaf_specs(c)
    assert [(B, m, p, n) for B, m, p, _, n in got] == \
        [(1, 4, math.prod(s), 5) for _, s, _ in specs]
    assert {p for (p, _, _), l in zip(specs, got) if l[3] == 4} == \
        set(Z.F32_LEAVES)
    assert {l[3] for l in got} == {2, 4}


def test_the_control_and_every_fault_fail_where_the_program_passes():
    w = load_json(DATA / "workloads" / f"{CELL}.json")
    cell = DRV.build(Context(ROOT, CELL, w, CFG, SEED, "cpu"))
    cell.setup()
    cell.close()
    assert not _fails(cell.numbers(), w["limits"])
    for fault in FAULTS:
        nums = cell.control_numbers(None if fault == "control" else fault)
        assert _fails(nums, w["limits"]), (fault, nums)


@pytest.fixture
def checkout(tmp_path):
    """A checkout whose cells are the test data's (as in
    test_bench_checks.py)."""
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "bench").mkdir()
    for name, src in (("drivers", ROOT / "bench" / "drivers"),
                      ("metrics", ROOT / "bench" / "metrics"),
                      ("workloads", DATA / "workloads"),
                      ("configs", DATA / "configs")):
        (tmp_path / "bench" / name).symlink_to(src, target_is_directory=True)
    return tmp_path


def _run(root):
    return run_cell(root, CELL, SEED, 0.3, False,
                    t_start=time.perf_counter(), device="cpu",
                    log=lambda m: None)


@pytest.mark.parametrize("fault", [None, "noembed", "noadapter", "alter"])
def test_faults_in_the_program_come_out_not_correct(fault, monkeypatch,
                                                    checkout):
    """A sound run is correct; the shared blocks reading zeros for e, the
    adapters left out, or a Mamba2 leaf's aggregate doubled is not."""
    from types import SimpleNamespace

    import repro_torch.core.protocol as P
    import repro_torch.models.blocks as B
    orig = B.zamba2_shared_block
    if fault == "noembed":
        monkeypatch.setattr(B, "zamba2_shared_block",
                            lambda p, ins, h, e, cfg:
                            orig(p, ins, h, torch.zeros_like(e), cfg))
    elif fault == "noadapter":
        def no_adapter(p, ins, h, e, cfg):
            ins = SimpleNamespace(**dict(vars(ins),
                                         adapter_a=ins.adapter_a * 0))
            return orig(p, ins, h, e, cfg)
        monkeypatch.setattr(B, "zamba2_shared_block", no_adapter)
    elif fault == "alter":
        dims = next(s for p, s, _ in Z.leaf_specs(CFG) if p == Z.ALTERED)
        orig_agg = P.wire_aggregate

        def altered(values, *a, **kw):
            out = orig_agg(values, *a, **kw)
            v = values[0] if isinstance(values, list) else values
            if tuple(v.shape[1:]) != dims:
                return out
            return [o * 2 for o in out] if isinstance(out, (list, tuple)) \
                else out * 2
        monkeypatch.setattr(P, "wire_aggregate", altered)
    res = _run(checkout)
    assert res["correct"] is (fault is None), res["checks"]


def test_a_program_without_the_config_is_refused_at_once(monkeypatch):
    import repro_torch.configs.base as base
    monkeypatch.delattr(base, "Zamba2Config")
    w = load_json(DATA / "workloads" / f"{CELL}.json")
    with pytest.raises(RuntimeError, match="no Zamba2Config"):
        DRV.build(Context(ROOT, CELL, w, CFG, SEED, "cpu"))
