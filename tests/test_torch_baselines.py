"""The comparison baselines: repro_torch's ``newton_estimator`` and
``gd_estimator`` against repro's, on the same numpy shards, with the
reference's own key-split draws handed to the port.

The reference's Newton baseline splits its key 6 ways: "R1 theta" noise
(0) and attack (1), "R2 grad" noise (2), "R2 hessian" noise (3), "R2 grad"
attack (4), "R2 hessian" attack (5); GD splits it ``2 * rounds`` ways,
"GD round t" noise (2t) and attack (2t + 1). Noise and the attacks that
draw consume their key unsplit as ``jax.random.normal(key, shape)``.

Tolerance: theta within atol = rtol = 1e-4. The accountant's names,
budgets and every sigma are exact, except the Newton baseline's R1 sigma
when lambda is calibrated from the machines' local Hessians: it divides by
the median of their smallest eigenvalues, which LAPACK (port) and XLA
(reference) compute a few ulp apart, so it matches to 1e-6 relative
(exactly with ``lambda_s`` fixed). ``bytes_per_machine`` is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProtocolConfig as JConfig
from repro.core.baselines import gd_estimator as jgd
from repro.core.baselines import newton_estimator as jnewton
from repro.core.losses import get_problem as jproblem
from repro_torch.agg import kernel as tkernel
from repro_torch.core.baselines import gd_estimator as tgd
from repro_torch.core.baselines import newton_estimator as tnewton
from repro_torch.core.losses import get_problem as tproblem
from repro_torch.interop import config_from_reference

M, N, P = 7, 200, 5


def _data(model, seed, n=N):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M + 1, n, P)).astype(np.float32)
    z = X @ np.full(P, 0.5 / np.sqrt(P), np.float32)
    if model == "logistic":
        y = rng.random((M + 1, n)) < 1.0 / (1.0 + np.exp(-z))
    else:
        y = rng.poisson(np.exp(np.clip(z, -1.0, 1.0)))
    mask = np.zeros(M, bool)
    mask[rng.choice(M, 2, replace=False)] = True
    return X, y.astype(np.float32), mask


def _normal(key, shape):
    return np.array(jax.random.normal(key, shape, jnp.float32))


def newton_draws(key):
    """The reference Newton baseline's draws, keyed by transmission."""
    k = jax.random.split(key, 6)
    vec, mat = (M + 1, P), (M + 1, P, P)
    noise = {"R1 theta": _normal(k[0], vec), "R2 grad": _normal(k[2], vec),
             "R2 hessian": _normal(k[3], mat)}
    attack = {"R1 theta": _normal(k[1], vec), "R2 grad": _normal(k[4], vec),
              "R2 hessian": _normal(k[5], mat)}
    return noise, attack


def gd_draws(key, rounds):
    k = jax.random.split(key, 2 * rounds)
    noise = {f"GD round {t}": _normal(k[2 * t], (M + 1, P))
             for t in range(rounds)}
    attack = {f"GD round {t}": _normal(k[2 * t + 1], (M + 1, P))
              for t in range(rounds)}
    return noise, attack


def _assert_same(got, ref, sigma0_rtol=0.0):
    np.testing.assert_allclose(got.theta.numpy(), np.asarray(ref.theta),
                               atol=1e-4, rtol=1e-4)
    assert got.bytes_per_machine == ref.bytes_per_machine
    g, r = got.accountant.records, ref.accountant.records
    assert [(x.name, x.eps, x.delta, x.failure_prob) for x in g] \
        == [(x.name, x.eps, x.delta, x.failure_prob) for x in r]
    assert [x.sigma for x in g[1:]] == [x.sigma for x in r[1:]]
    if sigma0_rtol:
        assert g[0].sigma == pytest.approx(r[0].sigma, rel=sigma0_rtol)
    else:
        assert g[0].sigma == r[0].sigma


def _tensors(X, y, mask):
    return (torch.from_numpy(X), torch.from_numpy(y),
            None if mask is None else torch.from_numpy(mask))


CASES = [
    # model, attack, byzantine, noiseless, lambda_s
    ("logistic", "scale", True, False, None),
    ("logistic", "alie", True, False, None),
    ("logistic", "gauss", True, False, 0.25),
    ("logistic", "scale", False, True, None),
    ("poisson", "signflip", True, False, 0.25),
    ("poisson", "alie", True, True, None),
]
IDS = [f"{c[0]}-{c[1]}" + ("-byz" if c[2] else "")
       + ("-noiseless" if c[3] else "") + ("-lambda" if c[4] else "")
       for c in CASES]


@pytest.mark.parametrize("model,attack,byz,noiseless,lam", CASES, ids=IDS)
def test_newton_matches_jax(model, attack, byz, noiseless, lam):
    jcfg = JConfig(noiseless=noiseless, lambda_s=lam)
    X, y, mask = _data(model, seed=len(attack) + 3 * byz)
    mask = mask if byz else None
    key = jax.random.PRNGKey(21)
    ref = jnewton(jproblem(model), jcfg, key, X, y,
                  byz_mask=None if mask is None else jnp.asarray(mask),
                  attack=attack)
    noise, attack_noise = newton_draws(key)
    before = tkernel.launches
    got = tnewton(tproblem(model), config_from_reference(
        dataclasses.asdict(jcfg)), *_tensors(X, y, mask), attack=attack,
        noise=noise, attack_noise=attack_noise)
    assert tkernel.launches == before     # CPU tensors: the plain path
    _assert_same(got, ref, sigma0_rtol=0.0 if lam else 1e-6)


@pytest.mark.parametrize("model,attack,byz,noiseless,lam", CASES, ids=IDS)
def test_gd_matches_jax(model, attack, byz, noiseless, lam):
    jcfg = JConfig(noiseless=noiseless, lambda_s=lam)
    X, y, mask = _data(model, seed=len(attack) + 5 * byz)
    mask = mask if byz else None
    key = jax.random.PRNGKey(23)
    rounds = 20 if attack in ("scale", "alie") else 8
    ref = jgd(jproblem(model), jcfg, key, X, y, rounds=rounds,
              byz_mask=None if mask is None else jnp.asarray(mask),
              attack=attack)
    noise, attack_noise = gd_draws(key, rounds)
    Xt, yt, mt = _tensors(X, y, mask)
    got = tgd(tproblem(model), config_from_reference(
        dataclasses.asdict(jcfg)), Xt, yt, rounds=rounds, byz_mask=mt,
        attack=attack, noise=noise, attack_noise=attack_noise)
    _assert_same(got, ref)


def test_newton_projects_a_noisy_hessian_onto_the_pd_cone(monkeypatch):
    """Large Hessian noise at small n (eps = 10, n = 20): the aggregated
    Hessian has negative eigenvalues, which both packages clamp to the
    1e-3 floor; the projected solve still agrees at 1e-4.

    Not at any noise: the clamped directions are amplified 1000-fold, so
    at eps = 0.5 (|theta| ~ 2e4) the two packages differ by 0.3% relative,
    the float32 eigenvectors of LAPACK (port) and XLA (reference) a few
    ulp apart times that gain."""
    jcfg = JConfig(eps=10.0, lambda_s=0.25)
    X, y, mask = _data("logistic", seed=0, n=20)
    key = jax.random.PRNGKey(2)
    ref = jnewton(jproblem("logistic"), jcfg, key, X, y,
                  byz_mask=jnp.asarray(mask))
    noise, attack_noise = newton_draws(key)
    seen = []
    eigh = torch.linalg.eigh

    def spy(a):
        out = eigh(a)
        seen.append(out.eigenvalues.min().item())
        return out
    monkeypatch.setattr(torch.linalg, "eigh", spy)
    got = tnewton(tproblem("logistic"), config_from_reference(
        dataclasses.asdict(jcfg)), *_tensors(X, y, mask), noise=noise,
        attack_noise=attack_noise)
    assert len(seen) == 1 and seen[0] < 0.0
    _assert_same(got, ref)


def test_port_native_draws_and_input_checks():
    X, y, mask = _data("logistic", seed=4)
    cfg = config_from_reference(dataclasses.asdict(JConfig()))
    Xt, yt, mt = _tensors(X, y, mask)
    a = tnewton(tproblem("logistic"), cfg, Xt, yt, mt, "gauss",
                generator=torch.Generator().manual_seed(0))
    b = tnewton(tproblem("logistic"), cfg, Xt, yt, mt, "gauss",
                generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(a.theta).all()
    assert torch.equal(a.theta, b.theta)
    g = tgd(tproblem("logistic"), cfg, Xt, yt, rounds=5, byz_mask=mt,
            generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(g.theta).all() and len(g.accountant.records) == 5
    with pytest.raises(ValueError, match="generator or pre-drawn noise"):
        tnewton(tproblem("logistic"), cfg, Xt, yt)
    with pytest.raises(ValueError, match="attack_noise"):
        tgd(tproblem("logistic"), cfg, Xt, yt, byz_mask=mt, attack="gauss",
            noise=gd_draws(jax.random.PRNGKey(0), 20)[0])
    with pytest.raises(ValueError, match="shape"):
        tnewton(tproblem("logistic"), cfg, Xt[:, :, :3], yt,
                noise=newton_draws(jax.random.PRNGKey(0))[0])
