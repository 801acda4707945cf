"""The slice end to end: repro_torch's Algorithm 1 against repro's
``protocol_rounds`` at the smoke shapes (m = 7, n = 200, p = 5), on the
same numpy data, with the reference's own draws handed to the port.

The reference splits its key 16 ways (``protocol.py:280``) and each flat
transmission consumes its keys unsplit: noise ``jax.random.normal(keys[i],
shape)`` and the draws of the attacks that draw ``keys[i + 1]``, with
i = 0, 2, 4, 6, 8, 10 for R1, R2, R2b, R3, R4, R5.

Tolerance: theta_cq/os/qn within atol = rtol = 1e-4. The relative part
matters: attacked runs can diverge to |theta| ~ 1e4. The spend ledgers
(eps, delta, failure probabilities) and every sigma but the first match
exactly; sigma[0] is the median of s1 / lambda_j, with lambda_j the
smallest eigenvalue of each machine's local Hessian, which LAPACK (port)
and XLA (reference) compute from float32 inputs a few ulp apart, so it
matches to 1e-6 relative (exactly when lambda_s is fixed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ProtocolConfig as JConfig
from repro.core.losses import get_problem as jproblem
from repro.core.protocol import DPQNProtocol as JProtocol
from repro.core.protocol import protocol_rounds as jrounds
from repro_torch import agg as tagg
from repro_torch.agg import kernel as tkernel
from repro_torch.core.losses import get_problem as tproblem
from repro_torch.core.protocol import DPQNProtocol as TProtocol
from repro_torch.core.protocol import protocol_rounds as trounds
from repro_torch.core.protocol import transmission_names
from repro_torch.interop import config_from_reference, inputs_from_numpy

M, N, P = 7, 200, 5
KEY_INDEX = {"R1 theta": 0, "R2 grad": 2, "R2b var": 4, "R3 newton-dir": 6,
             "R4 grad-diff": 8, "R5 bfgs-dir": 10}
THETAS = ("theta_cq", "theta_os", "theta_qn")


def _data(model, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M + 1, N, P)).astype(np.float32)
    z = X @ np.full(P, 0.5 / np.sqrt(P), np.float32)
    if model == "logistic":
        y = rng.random((M + 1, N)) < 1.0 / (1.0 + np.exp(-z))
    else:
        y = rng.poisson(np.exp(np.clip(z, -1.0, 1.0)))
    mask = np.zeros(M, bool)
    mask[rng.choice(M, 2, replace=False)] = True
    return X, y.astype(np.float32), mask


def _reference_draws(key, cfg):
    """The reference's noise and attack draws per transmission, numpy."""
    keys = jax.random.split(key, 16)
    noise, attack = {}, {}
    for name in transmission_names(cfg):
        rows = M if name == "R2b var" else M + 1
        i = KEY_INDEX[name]
        noise[name] = np.array(jax.random.normal(keys[i], (rows, P),
                                                 jnp.float32))
        attack[name] = np.array(jax.random.normal(keys[i + 1], (rows, P),
                                                  jnp.float32))
    return noise, attack


def _assert_thetas(got, ref):
    for f in THETAS:
        np.testing.assert_allclose(np.asarray(getattr(got, f)),
                                   np.asarray(getattr(ref, f)),
                                   atol=1e-4, rtol=1e-4, err_msg=f)


def _assert_ledgers(got, ref, sigma0_exact=False):
    for f in ("ledger_eps", "ledger_delta", "failure_probs"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    gs, rs = np.asarray(got.sigmas), np.asarray(ref.sigmas)
    np.testing.assert_array_equal(gs[..., 1:], rs[..., 1:])
    if sigma0_exact:
        np.testing.assert_array_equal(gs[..., 0], rs[..., 0])
    else:
        np.testing.assert_allclose(gs[..., 0], rs[..., 0], rtol=1e-6)


CASES = [
    # model, center trust, aggregator, attack, noiseless
    ("logistic", "trusted", "dcq", "scale", False),
    ("logistic", "trusted", "dcq", "gauss", False),
    ("logistic", "untrusted", "dcq", "signflip", False),
    ("logistic", "trusted", "median", "alie", False),
    ("logistic", "trusted", "trimmed", "scale", True),
    ("logistic", "trusted", "mean", "signflip", True),
    ("logistic", "untrusted", "trimmed", "gauss", True),
    ("poisson", "trusted", "dcq", "alie", False),
    ("poisson", "untrusted", "median", "gauss", False),
    ("poisson", "trusted", "trimmed", "signflip", False),
    ("poisson", "trusted", "mean", "scale", False),
    ("poisson", "untrusted", "dcq", "scale", True),
]


@pytest.mark.parametrize(
    "model,trust,aggregator,attack,noiseless", CASES,
    ids=["-".join(str(x) for x in c[:4]) + ("-noiseless" if c[4] else "")
         for c in CASES])
def test_protocol_rounds_matches_jax(model, trust, aggregator, attack,
                                     noiseless):
    jcfg = JConfig(aggregator=aggregator, center_trust=trust,
                   noiseless=noiseless)
    X, y, mask = _data(model, seed=len(model) + len(aggregator))
    key = jax.random.PRNGKey(17)
    ref = jax.jit(lambda k, X, y, mk: jrounds(
        k, X, y, jproblem(model), jcfg, byz_mask=mk, attack=attack))(
        key, X, y, mask)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    noise, attack_noise = _reference_draws(key, cfg)
    inp = inputs_from_numpy(X, y, mask, noise, attack_noise, device="cpu")
    got = trounds(inp["X"], inp["y"], tproblem(model), cfg,
                  byz_mask=inp["byz_mask"], attack=attack,
                  noise=inp["noise"], attack_noise=inp["attack_noise"])
    _assert_thetas(got, ref)
    _assert_ledgers(got, ref)


def test_fixed_lambda_gives_every_sigma_exactly():
    jcfg = JConfig(lambda_s=0.25)
    X, y, _ = _data("logistic", seed=3)
    key = jax.random.PRNGKey(5)
    ref = jax.jit(lambda k, X, y: jrounds(k, X, y, jproblem("logistic"),
                                          jcfg))(key, X, y)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    noise, _ = _reference_draws(key, cfg)
    inp = inputs_from_numpy(X, y, None, noise, device="cpu")
    got = trounds(inp["X"], inp["y"], tproblem("logistic"), cfg,
                  noise=inp["noise"])
    _assert_thetas(got, ref)
    _assert_ledgers(got, ref, sigma0_exact=True)


def test_run_monte_carlo_matches_jax_and_single_runs():
    """The replicate axis written out: R replicates at once equal the
    reference's vmap over R keys, and equal R single runs of the port."""
    R = 3
    jcfg = JConfig(center_trust="untrusted")
    X, y, mask = _data("logistic", seed=9)
    keys = jax.random.split(jax.random.PRNGKey(21), R)
    ref = JProtocol(jproblem("logistic"), jcfg).run_monte_carlo(
        keys, X, y, mask, attack="gauss", attack_factor=3.0)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    draws = [_reference_draws(k, cfg) for k in keys]
    noise = {n: np.stack([d[0][n] for d in draws]) for n in draws[0][0]}
    attack = {n: np.stack([d[1][n] for d in draws]) for n in draws[0][1]}
    proto = TProtocol(tproblem("logistic"), cfg, device="cpu")
    got = proto.run_monte_carlo(R, X, y, mask, "gauss", 3.0, noise=noise,
                                attack_noise=attack)
    assert got.theta_qn.shape == (R, P) and got.sigmas.shape == (R, 6)
    _assert_thetas(got, ref)
    _assert_ledgers(got, ref)
    for r in range(R):
        one = proto.run(X, y, mask, "gauss", 3.0,
                        noise={n: z[r] for n, z in noise.items()},
                        attack_noise={n: z[r] for n, z in attack.items()})
        for f in THETAS:
            # batched and single float32 products may sum in another order
            torch.testing.assert_close(getattr(one, f), getattr(got, f)[r],
                                       atol=1e-6, rtol=1e-5)
        assert one.noise_sd["s6"] == float(got.sigmas[r, 2])


def test_run_rebuilds_the_reference_accountant():
    jcfg = JConfig()
    X, y, mask = _data("poisson", seed=4)
    key = jax.random.PRNGKey(8)
    ref = JProtocol(jproblem("poisson"), jcfg).run(key, X, y, mask)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    noise, _ = _reference_draws(key, cfg)
    got = TProtocol(tproblem("poisson"), cfg, device="cpu").run(
        X, y, mask, noise=noise)
    assert set(got.noise_sd) == set(ref.noise_sd)
    for g, r in zip(got.accountant.records, ref.accountant.records):
        assert (g.name, g.eps, g.delta, g.failure_prob) \
            == (r.name, r.eps, r.delta, r.failure_prob)
        assert g.sigma == pytest.approx(r.sigma, rel=1e-6)
    assert got.accountant.total_basic() == ref.accountant.total_basic()
    np.testing.assert_allclose(got.theta_qn.numpy(), np.asarray(ref.theta_qn),
                               atol=1e-4, rtol=1e-4)


def test_port_native_draws_and_input_checks():
    X, y, mask = _data("logistic", seed=6)
    cfg = config_from_reference(dataclasses.asdict(JConfig()))
    proto = TProtocol(tproblem("logistic"), cfg, device="cpu")
    a = proto.run_monte_carlo(4, X, y, mask, "gauss", 3.0,
                              generator=torch.Generator().manual_seed(0))
    b = proto.run_monte_carlo(4, X, y, mask, "gauss", 3.0,
                              generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(a.theta_qn).all()
    torch.testing.assert_close(a.theta_qn, b.theta_qn, atol=0, rtol=0)
    assert not torch.equal(a.theta_qn[0], a.theta_qn[1])
    with pytest.raises(ValueError, match="generator or pre-drawn noise"):
        proto.run(X, y)
    with pytest.raises(ValueError, match="attack_noise"):
        proto.run(X, y, mask, "gauss", noise=_reference_draws(
            jax.random.PRNGKey(0), cfg)[0])
    # every registered accountant runs (rdp scales basic's sigmas down);
    # an unregistered one is refused
    basic = proto.run(X, y, generator=torch.Generator().manual_seed(1))
    rdp = TProtocol(tproblem("logistic"), dataclasses.replace(
        cfg, accountant="rdp"), device="cpu").run(
        X, y, generator=torch.Generator().manual_seed(1))
    assert rdp.noise_sd["s2"] < basic.noise_sd["s2"]
    with pytest.raises(KeyError, match="unknown accountant"):
        TProtocol(tproblem("logistic"), dataclasses.replace(
            cfg, accountant="nope"), device="cpu").run(
            X, y, generator=torch.Generator())


def test_kernel_path_matches_reference_path(monkeypatch):
    """The slice with every aggregation forced through the kernel's
    wrapper (its plain version on the CPU) agrees with the sort-based
    reference path, at the same 1e-4 bound the card is held to."""
    X, y, mask = _data("logistic", seed=12)
    cfg = config_from_reference(dataclasses.asdict(JConfig()))
    noise, _ = _reference_draws(jax.random.PRNGKey(3), cfg)
    inp = inputs_from_numpy(X, y, mask, noise, device="cpu")
    kw = dict(byz_mask=inp["byz_mask"], noise=inp["noise"])
    ref = trounds(inp["X"], inp["y"], tproblem("logistic"), cfg, **kw)
    calls = []
    pick = tagg._pick_backend

    def forced(agg, backend, values, shape):
        calls.append(agg.name)
        return pick(agg, "kernel", values, shape)
    monkeypatch.setattr(tagg, "_pick_backend", forced)
    before = tkernel.launches
    got = trounds(inp["X"], inp["y"], tproblem("logistic"), cfg, **kw)
    assert len(calls) == 8 and tkernel.launches == before
    for f in THETAS:
        torch.testing.assert_close(getattr(got, f), getattr(ref, f),
                                   atol=1e-4, rtol=1e-4)
