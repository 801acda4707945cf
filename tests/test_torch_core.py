"""repro_torch's local math, DP floats, attacks, wire, data and interop
against the JAX package, plus the package boundary: the port imports
neither jax nor repro, and asks for the card unless told otherwise.
Inputs are numpy arrays from a seed, handed to both packages."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import attacks as jattacks
from repro.configs.base import ProtocolConfig as JConfig
from repro.core import bfgs as jbfgs
from repro.core import dp as jdp
from repro.core import local as jlocal
from repro.core import transport as jtransport
from repro.core.losses import get_problem as jproblem
from repro.data import synthetic as jsynth
from repro_torch import attacks as tattacks
from repro_torch import resolve_device
from repro_torch.configs.base import ProtocolConfig as TConfig
from repro_torch.core import bfgs as tbfgs
from repro_torch.core import dp as tdp
from repro_torch.core import local as tlocal
from repro_torch.core import transport as ttransport
from repro_torch.core.losses import get_problem as tproblem
from repro_torch.data import synthetic as tsynth
from repro_torch.interop import config_from_reference, inputs_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PROBLEMS = ("logistic", "poisson", "linear", "huber")
#: float32 reductions over <= 200 samples, summed in another order
ATOL, RTOL = 1e-5, 1e-4


def _shard(problem, seed, shape=(), n=60, p=4):
    rng = np.random.default_rng(seed)
    X = (0.7 * rng.standard_normal(shape + (n, p))).astype(np.float32)
    z = X @ np.full(p, 0.5 / np.sqrt(p), np.float32)
    if problem == "logistic":
        y = (rng.random(shape + (n,)) < 1 / (1 + np.exp(-z)))
    elif problem == "poisson":
        y = rng.poisson(np.exp(np.clip(z, -1, 1)))
    else:
        y = z + rng.standard_normal(shape + (n,))
    theta = (0.3 * rng.standard_normal(p)).astype(np.float32)
    return X, y.astype(np.float32), theta


def _close(got, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               atol=atol, rtol=rtol)


# ------------------------------------------------------------------ losses

@pytest.mark.parametrize("name", PROBLEMS)
def test_losses_match_jax(name):
    X, y, theta = _shard(name, seed=1)
    tp, jp = tproblem(name), jproblem(name)
    targs = (torch.from_numpy(theta), torch.from_numpy(X), torch.from_numpy(y))
    jargs = (jnp.asarray(theta), jnp.asarray(X), jnp.asarray(y))
    for fn in ("loss", "grad", "per_sample_grads", "hessian",
               "point_hess_weight", "grad_variance"):
        _close(getattr(tp, fn)(*targs), getattr(jp, fn)(*jargs))


@pytest.mark.parametrize("name", PROBLEMS)
def test_losses_broadcast_like_vmap(name):
    """theta (R, 1, p) against X (m, n, p): the reference's vmap over
    machines and replicates, written out as broadcasting."""
    X, y, _ = _shard(name, seed=2, shape=(3,))
    thetas = np.random.default_rng(3).standard_normal((2, 4)) \
        .astype(np.float32) * 0.3
    tp, jp = tproblem(name), jproblem(name)
    got = tp.hessian(torch.from_numpy(thetas)[:, None], torch.from_numpy(X),
                     torch.from_numpy(y))
    ref = jax.vmap(lambda t: jax.vmap(lambda Xi, yi: jp.hessian(t, Xi, yi))(
        jnp.asarray(X), jnp.asarray(y)))(jnp.asarray(thetas))
    assert got.shape == (2, 3, 4, 4)
    _close(got, ref)


# -------------------------------------------------------------- local math

@pytest.mark.parametrize("name", ("logistic", "poisson"))
def test_newton_solve_matches_jax(name):
    X, y, _ = _shard(name, seed=4, shape=(5,), n=200)
    jp = jproblem(name)
    ref = jax.vmap(lambda Xi, yi: jlocal.newton_solve(
        jp, jnp.zeros(4), Xi, yi))(jnp.asarray(X), jnp.asarray(y))
    got = tlocal.newton_solve(tproblem(name), torch.zeros(4),
                              torch.from_numpy(X), torch.from_numpy(y))
    assert got.shape == (5, 4)
    _close(got, ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("name", ("logistic", "poisson"))
def test_variance_plugins_match_jax(name):
    X, y, theta = _shard(name, seed=5, n=200)
    rng = np.random.default_rng(6)
    g = (0.1 * rng.standard_normal(4)).astype(np.float32)
    s = (0.1 * rng.standard_normal(4)).astype(np.float32)
    yv = (0.1 * rng.standard_normal(4)).astype(np.float32)
    tp, jp = tproblem(name), jproblem(name)
    t = [torch.from_numpy(a) for a in (theta, X, y)]
    j = [jnp.asarray(a) for a in (theta, X, y)]
    _close(tlocal.sandwich_diag_variance(tp, *t),
           jlocal.sandwich_diag_variance(jp, *j))
    _close(tlocal.grad_coordinate_variance(tp, *t),
           jlocal.grad_coordinate_variance(jp, *j))
    _close(tlocal.newton_dir_variance(tp, *t, torch.from_numpy(g)),
           jlocal.newton_dir_variance(jp, *j, jnp.asarray(g)))
    tv = tbfgs.make_v(torch.from_numpy(s), torch.from_numpy(yv))
    jv = jbfgs.make_v(jnp.asarray(s), jnp.asarray(yv))
    _close(tlocal.bfgs_dir_variance(tp, *t, tv, torch.from_numpy(g)),
           jlocal.bfgs_dir_variance(jp, *j, jv, jnp.asarray(g)))


def test_make_v_matches_jax_and_batches():
    rng = np.random.default_rng(7)
    s, y, x = (rng.standard_normal((3, 5)).astype(np.float32)
               for _ in range(3))
    tv = tbfgs.make_v(torch.from_numpy(s), torch.from_numpy(y))
    for r in range(3):
        jv = jbfgs.make_v(jnp.asarray(s[r]), jnp.asarray(y[r]))
        _close(tv.rho[r], jv.rho, atol=0, rtol=1e-6)
        for tr in (False, True):
            _close(tv(torch.from_numpy(x), transpose=tr)[r],
                   jv(jnp.asarray(x[r]), transpose=tr), atol=1e-6, rtol=1e-5)
    # rows(): the same operator on every row of a (R, k, p) stack
    rows = rng.standard_normal((3, 4, 5)).astype(np.float32)
    got = tv.rows()(torch.from_numpy(rows), transpose=True)
    for r in range(3):
        for k in range(4):
            torch.testing.assert_close(
                got[r, k], tbfgs.make_v(torch.from_numpy(s[r]),
                                        torch.from_numpy(y[r]))(
                    torch.from_numpy(rows[r, k]), transpose=True))


# -------------------------------------------------------------- DP floats

def test_dp_floats_match_jax():
    for p, n, g, eps, dl in ((5, 200, 2.0, 2.0, 0.01),
                             (10, 1000, 1.5, 6.0, 0.05 / 6)):
        for tail in ("subexp", "subgauss"):
            pairs = [
                (tdp.s1_theta(p, n, g, eps, dl, 0.7, tail),
                 jdp.s1_theta(p, n, g, eps, dl, 0.7, tail)),
                (tdp.s2_grad(p, n, g, eps, dl, tail),
                 jdp.s2_grad(p, n, g, eps, dl, tail)),
                (tdp.s3_newton_dir(p, n, g, eps, dl, 0.7, 1.3, tail),
                 jdp.s3_newton_dir(p, n, g, eps, dl, 0.7, 1.3, tail)),
                (tdp.s4_grad_diff(p, n, g, eps, dl, 0.2, tail),
                 jdp.s4_grad_diff(p, n, g, eps, dl, 0.2, tail)),
                (tdp.s5_bfgs_dir(p, n, g, eps, dl, 1.1, 0.4, tail),
                 jdp.s5_bfgs_dir(p, n, g, eps, dl, 1.1, 0.4, tail)),
                (tdp._tail_factor(n, tail), jdp._tail_factor(n, tail))]
            for got, ref in pairs:
                assert got == pytest.approx(ref, rel=1e-12, abs=0)
        pairs = [(tdp.s6_variance(p, n, 1.0, eps, dl),
                  jdp.s6_variance(p, n, 1.0, eps, dl)),
                 (tdp.noise_multiplier(eps, dl),
                  jdp.noise_multiplier(eps, dl)),
                 (tdp.gaussian_sigma(0.3, eps, dl),
                  jdp.gaussian_sigma(0.3, eps, dl)),
                 (tdp.mean_dp_failure_prob_subexp(p, n, g, 1.0, 1.0),
                  jdp.mean_dp_failure_prob_subexp(p, n, g, 1.0, 1.0)),
                 (tdp.mean_dp_failure_prob_subgauss(p, n, g, 1.0),
                  jdp.mean_dp_failure_prob_subgauss(p, n, g, 1.0)),
                 (tdp.compose_advanced(eps, dl, 6, 1e-3),
                  jdp.compose_advanced(eps, dl, 6, 1e-3))]
        for got, ref in pairs:
            assert got == pytest.approx(ref, rel=1e-12, abs=0)


def test_privacy_accountant_matches_jax():
    t, j = tdp.PrivacyAccountant(), jdp.PrivacyAccountant()
    for acct in (t, j):
        acct.spend("R1 theta", 1.0, 0.01, 0.5, 1e-3)
        acct.spend("R2 grad", 1.0, 0.01, 0.25)
    assert t.total_basic() == j.total_basic()
    assert t.total_advanced() == j.total_advanced()
    assert t.total_failure_prob() == j.total_failure_prob()
    assert t.summary() == j.summary()
    for acct in (t, j):
        acct.spend("R3 newton-dir", 2.0, 0.01, 0.1)
    with pytest.warns(RuntimeWarning):
        assert t.total_advanced() == t.total_basic()
    with pytest.warns(RuntimeWarning):
        j.total_advanced()
    assert t.notes == j.notes


# ----------------------------------------------------------------- attacks

@pytest.mark.parametrize("attack", jattacks.registered())
def test_attacks_match_jax(attack):
    rng = np.random.default_rng(8)
    values = rng.standard_normal((7, 6)).astype(np.float32)
    mask = np.zeros(7, bool)
    mask[[1, 4]] = True
    key = jax.random.PRNGKey(9)
    ref = jattacks.apply_attack(jnp.asarray(values), jnp.asarray(mask),
                                attack=attack, factor=2.5, key=key,
                                round_idx=2)
    draws = torch.from_numpy(np.array(
        jax.random.normal(key, values.shape, jnp.float32)))
    got = tattacks.apply_attack(torch.from_numpy(values),
                                torch.from_numpy(mask), attack=attack,
                                factor=2.5, key=draws, round_idx=2)
    _close(got, ref, atol=1e-6, rtol=1e-6)
    # honest rows come back bit-unchanged
    np.testing.assert_array_equal(got.numpy()[~mask], values[~mask])


def test_attack_registry_matches_jax():
    assert tattacks.registered() == jattacks.registered()
    assert tattacks.ALIASES == jattacks.ALIASES
    for name in jattacks.registered():
        t, j = tattacks.get_attack(name), jattacks.get_attack(name)
        assert (t.omniscient, t.needs_key, t.round_aware, t.factor_grid) \
            == (j.omniscient, j.needs_key, j.round_aware, j.factor_grid)
    with pytest.raises(ValueError, match="needs_key"):
        tattacks.apply_attack(torch.zeros((3, 2)),
                              torch.tensor([True, False, False]), "gauss")
    with pytest.raises(ValueError, match="unknown attack"):
        tattacks.apply_attack(torch.zeros((3, 2)),
                              torch.tensor([True, False, False]), "nope")


def test_gauss_attack_from_a_generator():
    values = torch.zeros((6, 3))
    mask = torch.tensor([False, True, False, True, False, False])
    g = torch.Generator().manual_seed(0)
    out = tattacks.apply_attack(values, mask, "gauss", factor=-4.0, key=g)
    assert (out[~mask] == 0).all() and (out[mask] != 0).all()
    m = tattacks.byzantine_mask(torch.Generator().manual_seed(1), 20, 0.15)
    assert m.dtype == torch.bool and int(m.sum()) == 3


# -------------------------------------------------------------------- wire

def test_wire_noise_matches_jax_bit_for_bit():
    rng = np.random.default_rng(10)
    values = rng.standard_normal((5, 4)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    z = np.array(jax.random.normal(key, values.shape, jnp.float32))
    sig_m = np.abs(rng.standard_normal(5)).astype(np.float32)
    for sig in (0.37, sig_m):
        ref = jtransport.wire_noise(key, jnp.asarray(values),
                                    jnp.asarray(sig) if np.ndim(sig)
                                    else sig)
        got = ttransport.wire_noise(torch.from_numpy(z),
                                    torch.from_numpy(values),
                                    torch.from_numpy(sig) if np.ndim(sig)
                                    else sig)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wire_batched_layout():
    """(R, m, p) with per-machine (R, m) sigma and per-replicate (R, 1)
    sigma; corrupt and aggregate act on the machine axis -2."""
    rng = np.random.default_rng(12)
    vals = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
    sig = torch.from_numpy(np.abs(rng.standard_normal((3, 6)))
                           .astype(np.float32))
    out = ttransport.wire_noise(z, vals, sig)
    torch.testing.assert_close(out, vals + sig[..., None] * z, atol=0,
                               rtol=0)
    out = ttransport.wire_noise(z, vals, sig[:, :1])
    torch.testing.assert_close(out, vals + sig[:, :1, None] * z, atol=0,
                               rtol=0)
    mask = torch.tensor([False, True, False, False, True, False])
    bad = ttransport.wire_corrupt(None, vals, mask, "scale", -3.0)
    torch.testing.assert_close(bad[:, mask], -3.0 * vals[:, mask])
    torch.testing.assert_close(bad[:, ~mask], vals[:, ~mask], atol=0, rtol=0)
    alie = ttransport.wire_corrupt(None, vals, mask, "alie", 1.0)
    for r in range(3):
        torch.testing.assert_close(
            alie[r], tattacks.apply_attack(vals[r], mask, "alie", 1.0))
    agg = ttransport.wire_aggregate(vals, "median")
    assert agg.shape == (3, 4)
    assert ttransport.wire_aggregate(vals[0, :, 0], "median").shape == ()


# -------------------------------------------------------------------- data

def test_synthetic_data_follows_the_reference_design():
    np.testing.assert_allclose(tsynth.toeplitz_cov(6, device="cpu").numpy(),
                               np.asarray(jsynth.toeplitz_cov(6)),
                               rtol=1e-6)
    np.testing.assert_array_equal(tsynth.target_theta(10, "cpu").numpy(),
                                  np.asarray(jsynth.target_theta(10)))
    g = torch.Generator().manual_seed(13)
    X, y = tsynth.make_shards(g, "logistic", 3, 4000, 5)
    assert X.shape == (4, 4000, 5) and y.shape == (4, 4000)
    assert X.dtype == y.dtype == torch.float32
    assert set(y.unique().tolist()) <= {0.0, 1.0}
    cov = torch.einsum("mni,mnj->ij", X, X) / (4 * 4000)
    np.testing.assert_allclose(cov.numpy(),
                               tsynth.toeplitz_cov(5, device="cpu").numpy(),
                               atol=0.05)
    X, y = tsynth.make_shards(g, "poisson", 2, 500, 5)
    theta = tsynth.target_theta(5, "cpu")
    assert (X @ theta).abs().max() <= 1.0
    assert (y >= 0).all() and (y == y.round()).all()
    X, y = tsynth.make_shards(g, "linear", 1, 300, 5)
    assert X.shape == (2, 300, 5) and y.shape == (2, 300)


# ----------------------------------------------------------------- interop

def test_config_round_trip_and_inputs():
    ref = JConfig(aggregator="median", center_trust="untrusted",
                  gammas=(1.0, 2.0, 3.0, 4.0, 5.0), lambda_s=0.5)
    cfg = config_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(TConfig)] \
        == [f.name for f in dataclasses.fields(JConfig)]
    assert TConfig() == config_from_reference(dataclasses.asdict(JConfig()))
    with pytest.raises(ValueError, match="unknown"):
        config_from_reference({"K": 10, "warp": 9})
    inp = inputs_from_numpy(np.zeros((3, 4, 2)), np.zeros((3, 4)),
                            np.array([1, 0]), noise={"R1 theta":
                                                     np.zeros((3, 2))},
                            device="cpu")
    assert inp["X"].dtype == torch.float32 and inp["byz_mask"].dtype \
        == torch.bool
    assert inp["noise"]["R1 theta"].shape == (3, 2)
    assert inp["attack_noise"] is None


# -------------------------------------------------------- package boundary

def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)} imports {mod}"


def test_port_runs_without_loading_jax():
    code = (
        "import sys, torch\n"
        "from repro_torch.configs.base import ProtocolConfig\n"
        "from repro_torch.core.losses import get_problem\n"
        "from repro_torch.core.protocol import DPQNProtocol\n"
        "from repro_torch.data.synthetic import make_shards\n"
        "g = torch.Generator().manual_seed(0)\n"
        "X, y = make_shards(g, 'logistic', 3, 50, 3)\n"
        "out = DPQNProtocol(get_problem('logistic'), ProtocolConfig(),\n"
        "                   device='cpu').run(X, y, generator=g)\n"
        "assert torch.isfinite(out.theta_qn).all()\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is available")
    from repro_torch.core.protocol import DPQNProtocol
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DPQNProtocol(tproblem("logistic"), TConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inputs_from_numpy(np.zeros((2, 3, 2)), np.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsynth.target_theta(4)
    assert resolve_device("cpu") == torch.device("cpu")
