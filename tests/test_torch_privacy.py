"""The privacy accountants: repro_torch.privacy and the accountant-aware
calibration of repro_torch.core against repro's, on a grid of total
budgets eps in {1, 5, 30}, delta in {1e-5, 0.05} and transmission counts
k in {5, 6, 20}.

Everything here is host floats (``math`` on Python floats, the same
expressions in the same order), so every number is compared bit for bit:
``per_round``, ``multiplier``, ``compose``, ``failure_prob``,
``multiplier_ratio``, ``calibrate_sigma_base`` and ``_failure_probs``.
The protocol's ledger under rdp and subexp is compared on the
reference's own draws: every entry exact except ``sigma`` of R1, the
median of s1 / lambda_j, which matches to 1e-6 relative (lambda_j is a
float32 ``eigvalsh`` that LAPACK and XLA compute a few ulp apart); theta_qn,
which diverges at that budget, within 1e-3 of its largest coordinate.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest
import torch

from repro import privacy as jprivacy
from repro.configs.base import ProtocolConfig as JConfig
from repro.core import dp as jdp
from repro.core import protocol as jprotocol
from repro.core.losses import get_problem as jproblem
from repro_torch import privacy as tprivacy
from repro_torch.core import dp as tdp
from repro_torch.core import protocol as tprotocol
from repro_torch.core.losses import get_problem as tproblem
from repro_torch.interop import config_from_reference

EPS = (1.0, 5.0, 30.0)
DELTAS = (1e-5, 0.05)
KS = (5, 6, 20)


def test_registry_matches_the_reference():
    assert tprivacy.registered() == jprivacy.registered()
    for name in tprivacy.registered():
        t, j = tprivacy.get_accountant(name), jprivacy.get_accountant(name)
        assert (t.exact_basic, t.high_prob, t.failure_prob is None) \
            == (j.exact_basic, j.high_prob, j.failure_prob is None)
    assert tprivacy.resolve(None) == "basic"
    with pytest.raises(KeyError, match="unknown accountant"):
        tprivacy.get_accountant("nope")


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("name", jprivacy.registered())
def test_accountant_entries_bit_equal(name, eps):
    t, j = tprivacy.get_accountant(name), jprivacy.get_accountant(name)
    for delta, k in itertools.product(DELTAS, KS):
        assert t.per_round(eps, delta, k) == j.per_round(eps, delta, k)
        assert t.multiplier(eps, delta, k) == j.multiplier(eps, delta, k)
        eps_r, delta_r = j.per_round(eps, delta, k)
        assert t.compose(eps_r, delta_r, k) == j.compose(eps_r, delta_r, k)
        assert tprivacy.multiplier_ratio(name, eps, delta, k) \
            == jprivacy.multiplier_ratio(name, eps, delta, k)
        if j.failure_prob is not None:
            for p, n, gamma in ((5, 200, 2.0), (10, 1000, 0.5)):
                assert t.failure_prob(p, n, gamma) \
                    == j.failure_prob(p, n, gamma)


def test_composition_functions_bit_equal():
    for eps, delta, k in itertools.product(EPS, DELTAS, KS):
        assert tdp.invert_advanced(eps, delta, k) \
            == jdp.invert_advanced(eps, delta, k)
        assert tdp.calibrate_rdp_multiplier(eps, delta, k) \
            == jdp.calibrate_rdp_multiplier(eps, delta, k)
        assert tdp.compose_advanced(eps / k, delta / k, k, delta) \
            == jdp.compose_advanced(eps / k, delta / k, k, delta)
        for mu in (0.5, 2.0):
            assert tdp.rdp_total_epsilon(mu, k, delta) \
                == jdp.rdp_total_epsilon(mu, k, delta)
            assert tdp.rdp_gaussian_epsilon(mu, 3.0, k) \
                == jdp.rdp_gaussian_epsilon(mu, 3.0, k)
    assert tdp.rdp_to_dp(1.5, 4.0, 1e-5) == jdp.rdp_to_dp(1.5, 4.0, 1e-5)
    for p, n, g in ((5, 200, 2.0), (10, 1000, 1.0)):
        assert tdp.mean_sensitivity_subgauss(p, n, g) \
            == jdp.mean_sensitivity_subgauss(p, n, g)
        assert tdp.mean_sensitivity_subexp(p, n, g) \
            == jdp.mean_sensitivity_subexp(p, n, g)
        assert tdp.variance_sensitivity(n, g) == jdp.variance_sensitivity(n, g)
    with pytest.raises(ValueError):
        tdp.rdp_to_dp(1.0, 1.0, 1e-5)
    with pytest.raises(ValueError):
        tdp.variance_sensitivity(100, 0.5)


def test_multiplier_ratio_refuses_tensor_budgets():
    with pytest.raises(TypeError, match="Python numbers"):
        tprivacy.multiplier_ratio("rdp", torch.tensor(5.0), 1e-5, 6)
    # exact_basic entries never look at the budget
    assert tprivacy.multiplier_ratio("subexp", torch.tensor(5.0), 1e-5,
                                     6) == 1.0
    assert tprivacy.multiplier_ratio("rdp", 5.0, 1e-5, 6) \
        == pytest.approx(0.377, abs=1e-3)


@pytest.mark.parametrize("trust", ("trusted", "untrusted"))
@pytest.mark.parametrize("name", jprivacy.registered())
def test_calibration_bit_equal(name, trust):
    for eps, delta, noiseless in itertools.product(EPS, DELTAS,
                                                   (False, True)):
        jcfg = JConfig(eps=eps, delta=delta, accountant=name,
                       center_trust=trust, noiseless=noiseless,
                       gammas=(2.0, 1.5, 2.0, 0.5, 2.0))
        cfg = config_from_reference(dataclasses.asdict(jcfg))
        for p, n in ((5, 200), (10, 1000)):
            assert tprotocol.calibrate_sigma_base(cfg, p, n) \
                == jprotocol.calibrate_sigma_base(jcfg, p, n)
            assert tprotocol._failure_probs(cfg, p, n) \
                == jprotocol._failure_probs(jcfg, p, n)
        assert tprotocol.accountant_round_budget(cfg) \
            == jprotocol.accountant_round_budget(jcfg)


M, N, P = 7, 200, 5
KEY_INDEX = {"R1 theta": 0, "R2 grad": 2, "R2b var": 4, "R3 newton-dir": 6,
             "R4 grad-diff": 8, "R5 bfgs-dir": 10}


@pytest.mark.parametrize("trust", ("trusted", "untrusted"))
@pytest.mark.parametrize("name", ("rdp", "subexp"))
def test_protocol_ledger_matches_the_reference(name, trust):
    jcfg = JConfig(eps=5.0, delta=1e-5, accountant=name, center_trust=trust)
    rng = np.random.default_rng(7)
    X = rng.standard_normal((M + 1, N, P)).astype(np.float32)
    z = X @ np.full(P, 0.5 / np.sqrt(P), np.float32)
    y = (rng.random((M + 1, N)) < 1.0 / (1.0 + np.exp(-z))) \
        .astype(np.float32)
    key = jax.random.PRNGKey(11)
    ref = jprotocol.DPQNProtocol(jproblem("logistic"), jcfg).run(key, X, y)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    keys = jax.random.split(key, 16)
    noise = {name_: np.array(jax.random.normal(
        keys[KEY_INDEX[name_]], (M if name_ == "R2b var" else M + 1, P)))
        for name_ in tprotocol.transmission_names(cfg)}
    got = tprotocol.DPQNProtocol(tproblem("logistic"), cfg,
                                 device="cpu").run(X, y, noise=noise)
    g, r = got.accountant.records, ref.accountant.records
    assert [(x.name, x.eps, x.delta, x.failure_prob) for x in g] \
        == [(x.name, x.eps, x.delta, x.failure_prob) for x in r]
    assert [x.sigma for x in g[1:]] == [x.sigma for x in r[1:]]
    assert g[0].sigma == pytest.approx(r[0].sigma, rel=1e-6)
    assert got.accountant.total_basic() == ref.accountant.total_basic()
    assert got.accountant.total_failure_prob() \
        == ref.accountant.total_failure_prob()
    # at this budget theta_qn diverges (|theta| up to ~2e4 untrusted) and
    # float32 summation order moves it by ~1e-4 of its largest coordinate:
    # compared at 1e-3 of that scale here; converging budgets are held at
    # 1e-4 in test_torch_protocol.py and test_torch_sweep.py
    t, r = got.theta_qn.numpy(), np.asarray(ref.theta_qn)
    assert np.abs(t - r).max() <= 1e-3 * max(1.0, np.abs(r).max())
