"""What decides ``correct`` comes out false when it should: the control
(the reference in the precision below the configuration's, in the
program's place) fails a cell's numbers, and a whole run of the harness,
past its look for a card, comes out not correct with the timed path
broken underneath (a step that leaves its state unchanged, half of the
batch left out with the mean taken over the rest, an answer altered where
it is produced, the DP noise left out or its sigma doubled). At a test size on the CPU; on the card the same readings
were taken at the cells' own sizes (``bench/tools/calibrate.py``)."""
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))

from bench.lib.harness import (Context, load_json, load_module,  # noqa: E402
                               run_cell)

DATA = ROOT / "bench" / "tests" / "data"
SEED = 2 ** 33 + 12345


def _cell(name, seed=SEED):
    w = load_json(DATA / "workloads" / f"{name}.json")
    c = load_json(DATA / "configs" / f"{w['config']}.json")
    drv = load_module(ROOT / "bench" / "drivers" / f"{w['driver']}.py",
                      w["driver"])
    return drv.build(Context(ROOT, name, w, c, seed, "cpu")), w


@pytest.fixture
def checkout(tmp_path):
    """A checkout whose cells are the test data's: ``BENCHMARK.json`` and
    the drivers and metric readers as they are, the workloads and the
    configurations from ``bench/tests/data``."""
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "bench").mkdir()
    for name, src in (("drivers", ROOT / "bench" / "drivers"),
                      ("metrics", ROOT / "bench" / "metrics"),
                      ("workloads", DATA / "workloads"),
                      ("configs", DATA / "configs")):
        (tmp_path / "bench" / name).symlink_to(src, target_is_directory=True)
    return tmp_path


def _run(root, name, seconds=0.3):
    return run_cell(root, name, SEED, seconds, False,
                    t_start=time.perf_counter(), device="cpu",
                    log=lambda m: None)


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", ["tiny-qn", "tiny-adamw"])
def test_the_control_fails_and_the_program_passes(name):
    cell, w = _cell(name)
    cell.setup()
    cell.close()
    assert not _fails(cell.numbers(), w["limits"])
    assert _fails(cell.control_numbers(), w["limits"])


def test_the_serve_control_fails_and_the_program_passes():
    cell, w = _cell("tiny-serve")
    cell.setup()
    for _ in range(40):
        cell.step()
    cell.close()
    assert not _fails(cell.numbers(), w["limits"])
    assert _fails(cell.control_numbers(), w["limits"])


@pytest.mark.parametrize("name", ["tiny-qn-f32", "tiny-adamw-f32",
                                  "tiny-serve"])
def test_a_sound_run_is_correct(name, checkout):
    res = _run(checkout, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _halve_positions(monkeypatch):
    import repro_torch.train.trainer as T
    orig = T.split_machines

    def half(batch, m):
        return {k: v[..., :v.shape[-1] // 2]
                for k, v in orig(batch, m).items()}
    monkeypatch.setattr(T, "split_machines", half)


def _double_leaf(module, name, monkeypatch, leaf_dims):
    orig = getattr(module, name)

    def altered(values, *a, **kw):
        out = orig(values, *a, **kw)
        v = values[0] if isinstance(values, list) else values
        if tuple(v.shape[1:]) == leaf_dims:
            out = [o * 2 for o in out] if isinstance(out, (list, tuple)) \
                else out * 2
        return out
    monkeypatch.setattr(module, name, altered)


#: what a planted noise fault does to every sigma
NOISE_SCALE = {"nonoise": 0.0, "sigma2": 2.0}


def _scaled(sigma, fault):
    from repro_torch.core.transport import tree_map
    return tree_map(lambda s: s * NOISE_SCALE[fault], sigma)


def _scale_noise(module, name, at, monkeypatch, fault):
    """``module.name`` (a noise draw of the wire) with its sigma, the
    positional argument ``at``, scaled as ``fault`` says."""
    orig = getattr(module, name)

    def scaled(*args):
        args = list(args)
        args[at] = _scaled(args[at], fault)
        return orig(*args)
    monkeypatch.setattr(module, name, scaled)


def _w_k_dims(name):
    w = load_json(DATA / "workloads" / f"{name}.json")
    c = load_json(DATA / "configs" / f"{w['config']}.json")
    return (c["n_layers"], c["d_model"], c["n_kv_heads"] * c["head_dim"])


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter", "nonoise",
                                   "sigma2"])
def test_qn_faults_come_out_not_correct(fault, monkeypatch, checkout):
    import repro_torch.core.protocol as P
    import repro_torch.train.trainer as T
    if fault == "unchanged":
        orig = T.protocol_tree_rounds

        def still(key, theta, *a, **kw):
            return orig(key, theta, *a, **kw)._replace(theta_qn=theta)
        monkeypatch.setattr(T, "protocol_tree_rounds", still)
    elif fault == "half":
        _halve_positions(monkeypatch)
    elif fault == "alter":
        _double_leaf(P, "wire_aggregate", monkeypatch,
                     _w_k_dims("tiny-qn-f32"))
    else:
        _scale_noise(P, "wire_noise", 2, monkeypatch, fault)
    assert not _run(checkout, "tiny-qn-f32")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter", "nonoise",
                                   "sigma2"])
def test_adamw_faults_come_out_not_correct(fault, monkeypatch, checkout):
    import repro_torch.dist.grad_agg as A
    import repro_torch.train.trainer as T
    if fault == "unchanged":
        monkeypatch.setattr(T, "apply_updates", lambda params, upd: params)
    elif fault == "half":
        _halve_positions(monkeypatch)
    elif fault == "alter":
        _double_leaf(A, "aggregate_machine_axis", monkeypatch,
                     _w_k_dims("tiny-adamw-f32"))
    else:
        _scale_noise(A, "add_dp_noise", 1, monkeypatch, fault)
    assert not _run(checkout, "tiny-adamw-f32")["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "alter", "nonoise",
                                   "sigma2"])
def test_serve_faults_come_out_not_correct(fault, monkeypatch, checkout):
    import repro_torch.serve.service as S
    if fault in NOISE_SCALE:
        init = S.AggregationService.__init__

        def scaled(self, *a, **kw):
            init(self, *a, **kw)
            self._sigma = _scaled(self._sigma, fault)
        monkeypatch.setattr(S.AggregationService, "__init__", scaled)
        assert not _run(checkout, "tiny-serve")["correct"]
        return
    orig = S.wire_aggregate

    def broken(values, method, **kw):
        if fault == "half":
            kw["fill"] = kw["fill"] // 2
        out = orig(values, method, **kw)
        if fault == "unchanged":
            return torch.zeros_like(out)
        if fault == "alter":
            out = out.clone()
            out[0] = out[0] * 2
        return out
    monkeypatch.setattr(S, "wire_aggregate", broken)
    assert not _run(checkout, "tiny-serve")["correct"]
