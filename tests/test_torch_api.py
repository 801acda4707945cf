"""The port's facade, ``repro_torch.api``, against ``repro.api`` on the CPU:
the same public names and entry-point parameters as the snapshot in
tests/test_api.py, the same registry views, and the entry points on the
same data (``noiseless`` Algorithm 1 draws nothing, so the two packages
compute the same thetas: atol = rtol = 1e-4, as the protocol's parity
tests hold them). The paper's config (``configs/logistic_synthetic.py``)
carries across field for field.
"""
import dataclasses
import importlib.util
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as api
from repro.configs import logistic_synthetic as jls
from repro_torch.configs import logistic_synthetic as tls
from torch_threads import share_the_cores  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))


def _snapshot():
    """tests/test_api.py's API_SNAPSHOT and SIGNATURES, read from the file."""
    spec = importlib.util.spec_from_file_location(
        "reference_api_snapshot", os.path.join(HERE, "test_api.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.API_SNAPSHOT, mod.SIGNATURES


def test_public_surface_is_the_reference_snapshot():
    names, _ = _snapshot()
    assert set(api.__all__) == names == set(japi.__all__)
    assert all(hasattr(api, n) for n in api.__all__)


def test_entry_point_signatures_are_the_reference_snapshot():
    _, sigs = _snapshot()
    for name, params in sigs.items():
        sig = inspect.signature(getattr(api, name))
        got = [p for p in sig.parameters
               if sig.parameters[p].kind is not inspect.Parameter.VAR_KEYWORD]
        assert got == params, f"{name} signature drifted: {got}"


def test_registry_views_match_the_reference():
    assert api.registered_aggregators() == japi.registered_aggregators()
    assert api.registered_attacks() == japi.registered_attacks()


def test_paper_config_carries_across():
    assert dataclasses.asdict(tls.CONFIG) == dataclasses.asdict(jls.CONFIG)
    assert [f.name for f in dataclasses.fields(tls.RegressionConfig)] == \
        [f.name for f in dataclasses.fields(jls.RegressionConfig)]


@pytest.fixture(scope="module")
def shards():
    """Logistic data on 6 machines of 40 rows and 4 features, by numpy."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((6, 40, 4)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-X @ np.array([1.0, -0.5, 0.25, 0.0])))
    return X, (rng.random(p.shape) < p).astype(np.float32)


def test_run_protocol_facade_matches_the_reference(shards):
    X, y = shards
    jres = japi.run_protocol(jnp.asarray(X), jnp.asarray(y),
                             cfg=japi.ProtocolConfig(noiseless=True))
    res = api.run_protocol(torch.from_numpy(X), torch.from_numpy(y),
                           cfg=api.ProtocolConfig(noiseless=True),
                           device="cpu")
    assert res.theta_qn.shape == (4,)
    for name in ("theta_cq", "theta_os", "theta_qn"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(jres, name)),
                                   atol=1e-4, rtol=1e-4)
    arr = api.run_monte_carlo(X, y, reps=2, device="cpu",
                              cfg=api.ProtocolConfig(noiseless=True))
    assert arr.theta_qn.shape == (2, 4)
    np.testing.assert_allclose(arr.theta_qn[0].numpy(),
                               res.theta_qn.numpy(), atol=1e-6)


def test_keys_are_generators(shards):
    """``key``/``keys`` take torch generators; ``seed`` seeds one when
    none is given, so the same seed gives the same draws."""
    X, y = shards
    a = api.run_protocol(X, y, seed=3, device="cpu")
    b = api.run_protocol(X, y, key=torch.Generator().manual_seed(3),
                         device="cpu")
    c = api.run_protocol(X, y, seed=4, device="cpu")
    assert torch.equal(a.theta_qn, b.theta_qn)
    assert not torch.equal(a.theta_qn, c.theta_qn)
    m1 = api.run_monte_carlo(X, y, reps=3, seed=5, device="cpu")
    m2 = api.run_monte_carlo(X, y, reps=3, device="cpu",
                             keys=torch.Generator().manual_seed(5))
    assert torch.equal(m1.theta_qn, m2.theta_qn)
    assert res_ok(m1)


def res_ok(arr) -> bool:
    return arr.theta_qn.shape == (3, 4) and bool(
        torch.isfinite(arr.theta_qn).all())


def test_run_sweep_facade(tmp_path):
    from repro_torch.sweep import validate
    path = str(tmp_path / "s.json")
    art = api.run_sweep("smoke", fast=True, artifact_path=path,
                        device="cpu")
    validate(art)                       # raises on a schema violation
    assert os.path.exists(path) and len(art["scenarios"]) == 18
    # a mesh: every scenario's machines over its ranks, here a world of 1
    from repro_torch.launch.cli import sharded_run
    with sharded_run(None, "cpu", True) as mesh:
        one = api.run_sweep("smoke", fast=True, device="cpu", mesh=mesh)
    assert one["meta"]["n_devices"] == 1
    for sid, rec in one["scenarios"].items():
        assert rec["metrics"] == art["scenarios"][sid]["metrics"]


def test_serve_facade_runs():
    svc = api.serve(torch.zeros(4), method="median", capacity=6,
                    device="cpu")
    svc.submit_many(torch.randn((6, 4), generator=torch.Generator()
                                .manual_seed(0)))
    assert svc.round_idx == 1 and svc.theta.shape == (4,)
    with pytest.raises(ValueError):
        api.serve(torch.zeros(4), cfg=api.ServeConfig(), method="median",
                  device="cpu")
    # the ring buffer over a machine mesh, here a world of 1: the same
    # round as the unsharded service, bit for bit
    from repro_torch.launch.cli import sharded_run
    with sharded_run(None, "cpu", True) as mesh:
        one = api.serve(torch.zeros(4), method="median", capacity=6,
                        sharding=mesh, device="cpu")
        one.submit_many(torch.randn((6, 4), generator=torch.Generator()
                                    .manual_seed(0)))
    assert one.round_idx == 1 and torch.equal(one.theta, svc.theta)


def test_entry_points_need_the_card_unless_told(shards, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = shards
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run_protocol(X, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.serve(torch.zeros(4), method="median")
