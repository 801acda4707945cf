"""The scenario sweep: repro_torch.sweep against repro.sweep, on the CPU.

* Scenario ids, group keys, labels and ``to_json`` equal the reference's
  for every scenario of every ported preset, and under each
  ``--accountant`` override (pure Python).
* Parity: the port's ``SweepExecutor``, fed the reference's data
  (``repro.sweep.data.build_data``) and the reference's per-replicate
  draws through ``inputs``, reproduces the reference executor's artifact
  for small groups (trusted center with dcq under subexp; untrusted
  center with median under rdp and an attack that draws; digits pair
  (6, 9) at the table-1 size, eps 20 and 30). Digits points where
  theta_qn diverges are chaotic and held to their records only (see
  their test). The reference gives each replicate a
  key (``replicate_keys``) and ``protocol_rounds`` splits it 16 ways;
  transmission i consumes keys 2i (noise) and 2i + 1 (attack draws)
  unsplit, with i = 0..5 for R1, R2, R2b, R3, R4, R5.
  Tolerances: metrics within rtol = 1e-4 (relative: diverging attack
  points reach MRSE ~1e4), each replicate's theta within 1e-4 times
  max(1, its largest |coordinate|) (relative at diverging points, where a
  float32 ulp of a coordinate ~1e3 grows through five rounds); ``spend``
  exact but ``sigmas[0]`` (rtol = 1e-6: the median of s1 / lambda_j, with
  lambda_j from float32 ``eigvalsh``, which LAPACK and XLA compute a few
  ulp apart); ``comm`` exact.
* The port's own draws: one scenario at m = 7, n = 200, p = 5, reps = 64
  on the reference's data; its MRSE lies within 4 combined standard
  errors of the reference's.
* The artifact, the executor's resume and chunking, the CLI, and the
  refusals.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sweep as jsweep
from repro.sweep import data as jdata
from repro_torch import privacy, sweep as tsweep
from repro_torch.core.protocol import transmission_names
from repro_torch.interop import scenario_inputs_from_numpy
from repro_torch.sweep import artifact as tartifact
from repro_torch.sweep import cli as tcli
from repro_torch.sweep.executor import _spend_record

KEY_INDEX = {"R1 theta": 0, "R2 grad": 2, "R2b var": 4, "R3 newton-dir": 6,
             "R4 grad-diff": 8, "R5 bfgs-dir": 10}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -------------------------------------------------------------- identity

ACCOUNTANTS = (None,) + privacy.registered()


@pytest.mark.parametrize("accountant", ACCOUNTANTS,
                         ids=[a or "as-built" for a in ACCOUNTANTS])
@pytest.mark.parametrize("preset", sorted(tsweep.PRESETS))
def test_scenario_ids_equal_the_reference(preset, accountant):
    ref = jsweep.build_preset(preset)
    got = tsweep.build_preset(preset)
    if accountant is not None:
        ref = [dataclasses.replace(s, accountant=accountant) for s in ref]
        got = [dataclasses.replace(s, accountant=accountant) for s in got]
    for fast in (False, True):
        r = jsweep.fast_variant(ref) if fast else ref
        g = tsweep.fast_variant(got) if fast else got
        assert [s.scenario_id() for s in g] == [s.scenario_id() for s in r]
        assert [s.group_key() for s in g] == [s.group_key() for s in r]
        assert [s.to_json() for s in g] == [s.to_json() for s in r]
        assert [tsweep.group_label(k) for k in tsweep.group_scenarios(g)] \
            == [jsweep.group_label(k) for k in jsweep.group_scenarios(r)]
        for s in g:
            assert tsweep.scenario_from_json(s.to_json()) == s


def test_preset_registry_matches_the_reference_but_zoo_smoke():
    """Every preset of the reference, zoo-smoke included (its training
    scenarios are held in tests/test_torch_zoo.py)."""
    assert set(tsweep.PRESETS) == set(jsweep.PRESETS)
    sizes = {name: (len(tsweep.build_preset(name)),
                    len(tsweep.group_scenarios(tsweep.build_preset(name))))
             for name in ("paper", "untrusted", "attack-sensitivity",
                          "smoke", "zoo-smoke")}
    assert sizes == {"paper": (47, 10), "untrusted": (48, 12),
                     "attack-sensitivity": (126, 24), "smoke": (18, 9),
                     "zoo-smoke": (7, 6)}


@pytest.mark.parametrize("accountant", privacy.registered())
def test_every_preset_calibrates_under_every_accountant(accountant):
    """The spend record of every scenario of every ported preset under
    each accountant, against the reference's (exact host floats; the
    sigmas here are the basic-calibrated bases, no protocol run). A
    training scenario's record (zoo-smoke) is its per-leaf ledger over
    its reduced model's tree."""
    from repro.configs import get_config as jget_config
    from repro.core.protocol import calibrate_sigma_base as jbase
    from repro.models.model import Model as JModel
    from repro.sweep.executor import _spend_record as jspend
    from repro.sweep.executor import _train_spend_record as jtrain_spend
    from repro_torch.configs import get_config
    from repro_torch.core.protocol import calibrate_sigma_base as tbase
    from repro_torch.models.model import Model
    from repro_torch.sweep.executor import _train_spend_record
    seen = set()
    for name in sorted(tsweep.PRESETS):
        for s in tsweep.build_preset(name):
            s = dataclasses.replace(s, accountant=accountant)
            r = jsweep.scenario_from_json(s.to_json())
            key = s.group_key() + (s.eps, s.delta)
            if key in seen:
                continue
            seen.add(key)
            if isinstance(s, tsweep.TrainScenario):
                tree = Model(get_config(s.arch, reduced=True),
                             device="meta").params()
                shapes = jax.eval_shape(
                    JModel(jget_config(r.arch, reduced=True)).init,
                    jax.random.PRNGKey(0))
                assert _train_spend_record(s, tree) == \
                    jtrain_spend(r, shapes)
                continue
            base = tbase(s.protocol_config(), s.p, s.n)
            assert base == jbase(r.protocol_config(), r.p, r.n)
            assert _spend_record(s, np.asarray(base, np.float32)) \
                == jspend(r, np.asarray(base, np.float32))


# ---------------------------------------------------------------- parity

def _grid(**kw):
    common = dict(m_grid=(7,), n=200, p=5, reps=2, eps_grid=(10.0, 30.0),
                  byz_fracs=(0.15,))
    common.update(kw)
    return jsweep.ScenarioGrid(**common).expand()


def _digits(m, n, eps_grid=(5.0, 30.0)):
    return [jsweep.Scenario(problem="logistic", dataset="digits",
                            pair=(6, 9), m=m, n=n, p=5, eps=e,
                            gammas=(0.5,) * 5, attack_factor=3.0, reps=2,
                            data_seed=0)
            for e in eps_grid]


PARITY = (
    _grid(aggregators=("dcq",), attacks=("scale",), accountants=("subexp",))
    + _grid(aggregators=("median",), attacks=("gauss",),
            attack_factors=(3.0,), accountants=("rdp",),
            center_trusts=("untrusted",))
    + _digits(m=10, n=1000, eps_grid=(20.0, 30.0)))
PARITY_IDS = [s.scenario_id() for s in PARITY]
#: digits points where theta_qn diverges: the reference's own point
#: (tests/test_sweep.py) and eps = 5 at the table-1 size; see below
CHAOTIC = _digits(m=4, n=120) + _digits(m=10, n=1000, eps_grid=(5.0,))
#: the port's own draws against the reference's, at matched reps
NATIVE = jsweep.Scenario(m=7, n=200, p=5, eps=10.0, reps=64, data_seed=3)


def _reference_draws(scenario):
    """Per replicate, the reference's noise and attack draws, numpy."""
    cfg = tsweep.scenario_from_json(scenario.to_json()).protocol_config()
    noise, attack = [], []
    for key in jdata.replicate_keys(scenario):
        keys = jax.random.split(key, 16)
        nz, at = {}, {}
        for name in transmission_names(cfg):
            rows = scenario.m if name == "R2b var" else scenario.m + 1
            i = KEY_INDEX[name]
            shape = (rows, scenario.p)
            nz[name] = np.array(jax.random.normal(keys[i], shape,
                                                  jnp.float32))
            at[name] = np.array(jax.random.normal(keys[i + 1], shape,
                                                  jnp.float32))
        noise.append(nz)
        attack.append(at)
    return noise, attack


def _reference_inputs(with_draws=True):
    """``inputs`` for the port's executor: the reference's data, aux and
    (unless ``with_draws`` is False) its per-replicate draws."""
    by_id = {s.scenario_id(): s for s in PARITY + CHAOTIC + [NATIVE]}

    def inputs(s):
        ref = by_id[s.scenario_id()]
        X, y, aux = jdata.build_data(ref)
        draws = _reference_draws(ref) if with_draws else (None, None)
        return scenario_inputs_from_numpy(X, y, aux, *draws, device="cpu")
    return inputs


@pytest.fixture(scope="module")
def artifacts():
    """The reference executor's artifact and the port's, on the
    reference's data and draws; and the NATIVE scenario's pair."""
    ref = jsweep.SweepExecutor().run(PARITY + CHAOTIC + [NATIVE])
    scens = [tsweep.scenario_from_json(s.to_json())
             for s in PARITY + CHAOTIC]
    got = tsweep.SweepExecutor(device="cpu",
                               inputs=_reference_inputs()).run(scens)
    native = tsweep.SweepExecutor(
        device="cpu", inputs=_reference_inputs(with_draws=False)).run(
        [tsweep.scenario_from_json(NATIVE.to_json())])
    return ref, got, native


def _assert_thetas(got, ref, tol=1e-4):
    """Each replicate's theta within ``tol * max(1, max |theta|)``: a
    diverging attack point (|theta| ~ 1e3) is compared relatively."""
    got, ref = np.asarray(got), np.asarray(ref)
    scale = np.maximum(1.0, np.abs(ref).max(axis=-1, keepdims=True))
    assert (np.abs(got - ref) <= tol * scale).all(), \
        np.abs(got - ref).max() / scale.max()


@pytest.mark.parametrize("sid", PARITY_IDS)
def test_artifact_matches_the_reference(artifacts, sid):
    ref, got, _ = artifacts
    r, g = ref["scenarios"][sid], got["scenarios"][sid]
    assert g["scenario"] == r["scenario"]
    assert g["comm"] == r["comm"]
    assert set(g["metrics"]) == set(r["metrics"])
    for name, val in r["metrics"].items():
        assert g["metrics"][name] == pytest.approx(val, rel=1e-4), name
    _assert_thetas(g["thetas_qn"], r["thetas_qn"])
    gs, rs = dict(g["spend"]), dict(r["spend"])
    assert gs.pop("sigmas")[1:] == rs["sigmas"][1:]
    assert gs == {k: v for k, v in rs.items() if k != "sigmas"}
    assert g["spend"]["sigmas"][0] == pytest.approx(rs["sigmas"][0],
                                                    rel=1e-6)
    assert g["timing"]["group"] == r["timing"]["group"]
    assert g["timing"]["launches"] == 0           # CPU: the plain path


def test_chaotic_digits_point_is_held_to_its_records_only(artifacts):
    """The reference's digits point at m = 4, n = 120 (its own test,
    which fails on this tree) diverges: the local M-estimators of 120
    near-separable rows reach |theta| ~ 74, and Algorithm 1's five rounds
    carry theta_qn to ~1e9-1e12, so the accuracy is float32 rounding
    order. The reference does not reproduce itself there: the eps = 5
    point gives 0.9653 batched with eps = 30 and 0.0248 alone (its
    static per-key path 0.0246). At the table-1 size eps = 5 diverges
    too (|theta_qn| ~ 4e5; the two packages' thetas 1% apart, the
    accuracy equal). The port is held there to the same scenario, spend
    and comm records, the same data (bit for bit, through its own digits
    pipeline) and an accuracy in [0, 1]; eps = 20 and 30 at the table-1
    size, which converge, are in PARITY."""
    ref, got, _ = artifacts
    alone = jsweep.SweepExecutor().run(CHAOTIC[:1])
    sid = CHAOTIC[0].scenario_id()
    assert abs(alone["scenarios"][sid]["metrics"]["accuracy"]
               - ref["scenarios"][sid]["metrics"]["accuracy"]) > 0.5
    for s in CHAOTIC:
        sid = s.scenario_id()
        r, g = ref["scenarios"][sid], got["scenarios"][sid]
        assert g["scenario"] == r["scenario"] and g["comm"] == r["comm"]
        assert g["spend"]["sigmas"][1:] == r["spend"]["sigmas"][1:]
        assert 0.0 <= g["metrics"]["accuracy"] <= 1.0
        X, y, aux = jdata.build_data(s)
        tX, ty, taux = tsweep.data.build_data(
            tsweep.scenario_from_json(s.to_json()), "cpu")
        np.testing.assert_array_equal(tX.numpy(), np.asarray(X))
        np.testing.assert_array_equal(ty.numpy(), np.asarray(y))
        for k in ("Xte", "yte"):
            np.testing.assert_array_equal(taux[k].numpy(),
                                          np.asarray(aux[k]))


def test_native_draws_within_monte_carlo_error(artifacts):
    ref, _, native = artifacts
    sid = NATIVE.scenario_id()
    target = np.full(NATIVE.p, 0.5 / math.sqrt(NATIVE.p))

    def mrse_and_se(art):
        rse = np.linalg.norm(np.asarray(art["scenarios"][sid]["thetas_qn"])
                             - target, axis=-1)
        return rse.mean(), rse.std(ddof=1) / math.sqrt(len(rse))
    (a, sa), (b, sb) = mrse_and_se(native), mrse_and_se(ref)
    assert native["scenarios"][sid]["metrics"]["mrse_qn"] \
        == pytest.approx(a, rel=1e-5)
    assert abs(a - b) <= 4.0 * math.hypot(sa, sb), (a, b, sa, sb)


# ------------------------------------------------- artifact and executor

SMALL = [tsweep.Scenario(m=5, n=60, p=3, eps=e, reps=2, byz_frac=0.2,
                         attack=attack)
         for attack in ("scale", "gauss") for e in (5.0, 30.0)]


@pytest.fixture(scope="module")
def small_artifact():
    return tsweep.run_scenarios(SMALL, device="cpu")


def test_artifact_round_trip(tmp_path, small_artifact):
    path = str(tmp_path / "a.json")
    tsweep.save(small_artifact, path)
    back = tsweep.load(path)
    assert back == json.loads(json.dumps(small_artifact))
    assert tartifact.load_done_ids(path) == {s.scenario_id() for s in SMALL}
    assert small_artifact["meta"]["device"] == "cpu"
    assert small_artifact["meta"]["torch"] == torch.__version__
    csv = str(tmp_path / "a.csv")
    tsweep.to_csv(back, csv)
    assert len(open(csv).read().splitlines()) == len(SMALL) + 1


def test_validation_rejects_v2_and_incomplete_records(small_artifact):
    tsweep.validate(small_artifact)
    old = json.loads(json.dumps(small_artifact))
    old["schema_version"] = 2
    with pytest.raises(ValueError, match="schema_version"):
        tsweep.validate(old)
    sid = SMALL[0].scenario_id()
    for drop in ("comm", "spend.accountant"):
        bad = json.loads(json.dumps(small_artifact))
        rec = bad["scenarios"][sid]
        if drop == "comm":
            del rec["comm"]
        else:
            del rec["spend"]["accountant"]
        with pytest.raises(ValueError, match=drop.split(".")[-1]):
            tsweep.validate(bad)


def test_resume_from_partial_reproduces_the_results(tmp_path,
                                                    small_artifact):
    path = str(tmp_path / "r.json")
    tsweep.SweepExecutor(device="cpu").run(SMALL[:2], artifact_path=path)
    ex = tsweep.SweepExecutor(device="cpu")
    art = ex.run(SMALL, artifact_path=path)
    assert set(ex.launches) == {s.scenario_id() for s in SMALL[2:]}
    for s in SMALL:
        sid = s.scenario_id()
        assert art["scenarios"][sid]["metrics"] \
            == small_artifact["scenarios"][sid]["metrics"]
        assert art["scenarios"][sid]["thetas_qn"] \
            == small_artifact["scenarios"][sid]["thetas_qn"]


def test_chunked_group_equals_unchunked(tmp_path, small_artifact):
    path = str(tmp_path / "c.json")
    writes = []
    save = tartifact.save

    def counting(art, p):
        writes.append(len(art["scenarios"]))
        save(art, p)
    tartifact.save = counting
    try:
        art = tsweep.SweepExecutor(device="cpu", chunk_size=1).run(
            SMALL, artifact_path=path)
    finally:
        tartifact.save = save
    assert writes == [1, 2, 3, 4]
    for s in SMALL:
        rec = art["scenarios"][s.scenario_id()]
        assert rec["metrics"] \
            == small_artifact["scenarios"][s.scenario_id()]["metrics"]
        assert rec["timing"]["n_chunks"] == 2
        assert rec["timing"]["group_size"] == 1
    with pytest.raises(ValueError, match="chunk_size"):
        tsweep.SweepExecutor(device="cpu", chunk_size=0)


def test_cli_list_and_fast_smoke_on_the_cpu(tmp_path, capsys):
    assert tcli.main(["--preset", "paper", "--list"]) == 0
    out = capsys.readouterr().out
    assert "47 scenarios in 10 group(s)" in out
    path = str(tmp_path / "smoke.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.sweep", "--preset", "smoke",
         "--fast", "--device", "cpu", "--out", path, "--no-thetas"],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    art = tsweep.load(path)
    ids = {s.scenario_id()
           for s in tsweep.fast_variant(tsweep.build_preset("smoke"))}
    assert set(art["scenarios"]) == ids
    for rec in art["scenarios"].values():
        assert all(math.isfinite(v) for v in rec["metrics"].values())


@pytest.mark.parametrize("accountant", privacy.registered())
def test_fast_smoke_runs_under_every_accountant(tmp_path, accountant):
    path = str(tmp_path / "smoke.json")
    assert tcli.main(["--preset", "smoke", "--fast", "--device", "cpu",
                      "--out", path, "--accountant", accountant]) == 0
    art = tsweep.load(path)
    assert len(art["scenarios"]) == 18
    assert {rec["spend"]["accountant"]
            for rec in art["scenarios"].values()} == {accountant}


def test_refusals(monkeypatch, capsys, tmp_path):
    assert isinstance(tsweep.scenario_from_json(
        {"kind": "train", "arch": "xlstm-125m"}), tsweep.TrainScenario)
    assert tsweep.scenario_from_json(
        {"kind": "train", "arch": "llava-next-mistral-7b"}).arch == \
        "llava-next-mistral-7b"
    with pytest.raises(ValueError, match="unknown arch"):
        tsweep.scenario_from_json({"kind": "train", "arch": "gpt-x"})
    assert tcli.main(["--preset", "zoo-smoke", "--list"]) == 0
    assert "7 scenarios in 6 group(s)" in capsys.readouterr().out
    # --sharded runs: one process is a world of 1 (the ranks are in
    # tests/test_torch_dist_ranks.py); scenario thetas are one rank's
    path = str(tmp_path / "one.json")
    assert tcli.main(["--preset", "smoke", "--fast", "--device", "cpu",
                      "--sharded", "--out", path]) == 0
    assert tsweep.load(path)["meta"]["n_devices"] == 1
    assert "sharding the machine axis over 1 rank(s)" in \
        capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.SweepExecutor()
    assert tcli.main(["--preset", "smoke", "--fast", "--out",
                      "/nonexistent/never-written.json"]) == 1
    assert "device='cpu'" in capsys.readouterr().err
