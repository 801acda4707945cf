"""The reference's public names in the port: the DCQ efficiency theory
(``d_k``, ``are_dcq``, ``ARE_MEDIAN``, ``dcq_with_sigma``), the artifact
helpers (``merge``, ``get_metric``, ``thetas_qn``), ``make_loss_fn``,
``attacks.unregister``, ``transport.is_single_leaf``, ``dp.add_noise``
and ``synthetic.token_batches``, each against the reference on the same
inputs; and each port package's ``__all__`` against the reference's.

Tolerances: the DCQ constants 1e-6 relative (both compute in float32, from
quantile knots 2-3 ulp apart); ``dcq_with_sigma`` 1e-5 (the reference's
own DCQ parity); the loss tests/test_torch_train.py's 1e-5; the rest
exact.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agg import reference as jref
from repro.attacks import registry as jreg
from repro.core import dp as jdp
from repro.core import transport as jtransport
from repro.sweep import artifact as jart
from repro_torch.agg import reference as tref
from repro_torch.attacks import registry as treg
from repro_torch.core import dp as tdp
from repro_torch.core import transport as ttransport
from repro_torch.sweep import artifact as tart
from torch_threads import share_the_cores  # noqa: F401 (autouse)


# ------------------------------------------------------------ DCQ theory

@pytest.mark.parametrize("K", [1, 5, 10, 20])
def test_dcq_efficiency_constants_match_reference(K):
    assert tref.d_k(K) == pytest.approx(jref.d_k(K), rel=1e-6)
    assert tref.are_dcq(K) == pytest.approx(jref.are_dcq(K), rel=1e-6)
    assert tref.ARE_MEDIAN == float(jref.ARE_MEDIAN)
    # D_K -> pi/3 from above as K grows (the paper's ARE 3/pi limit)
    assert tref.d_k(K) > np.pi / 3


@pytest.mark.parametrize("K", [1, 5, 10, 20])
def test_dcq_with_sigma_matches_reference(K):
    rng = np.random.default_rng(K)
    v = rng.standard_normal((31, 7)).astype(np.float32)
    sc = (np.abs(rng.standard_normal(7)) + 0.5).astype(np.float32)
    jest, jsd = jref.dcq_with_sigma(jnp.asarray(v), jnp.asarray(sc), K=K)
    est, sd = tref.dcq_with_sigma(torch.from_numpy(v), torch.from_numpy(sc),
                                  K=K)
    np.testing.assert_allclose(est.numpy(), np.asarray(jest), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd), rtol=1e-6)
    assert sd.dtype == est.dtype == torch.float32
    # the machine axis elsewhere: the same estimate (up to the order of
    # the indicator sums) and the same s.d.
    est_t, sd_t = tref.dcq_with_sigma(torch.from_numpy(v.T.copy()),
                                      torch.from_numpy(sc), K=K, axis=1)
    np.testing.assert_allclose(est_t.numpy(), est.numpy(), atol=1e-6)
    assert torch.equal(sd_t, sd)


def test_dcq_names_are_exported_where_the_reference_exports_them():
    import repro_torch.agg as tagg
    import repro_torch.core as tcore
    for name in ("dcq", "dcq_with_sigma", "d_k", "are_dcq", "ARE_MEDIAN"):
        assert getattr(tagg, name) is getattr(tref, name)
        assert getattr(tcore, name) is getattr(tref, name)


# ------------------------------------------------------------ artifacts

def _record(i, thetas=True):
    return {"scenario": {"id": i}, "metrics": {"mrse_qn": 0.1 * i},
            "spend": {"eps_total": 1.0, "delta_total": 0.1,
                      "n_transmissions": 5, "sigmas": [1.0],
                      "accountant": "basic"},
            "comm": {"bytes_per_machine": 40, "bytes_per_round": 8,
                     "n_transmissions": 5},
            "timing": {"group": "g"},
            "thetas_qn": [[float(i), 2.0]] if thetas else None}


def _artifact(mod, ids, meta):
    art = mod.new_artifact(meta=meta)
    art["scenarios"] = {f"s{i}": _record(i, thetas=i != 3) for i in ids}
    return art


def test_merge_get_metric_thetas_qn_match_reference():
    for mod in (jart, tart):
        a = _artifact(mod, (1, 2), {"from": "a"})
        b = _artifact(mod, (2, 3), {"from": "b"})
        b["scenarios"]["s2"]["metrics"]["mrse_qn"] = 9.0
        merged = tart.merge(a, b)
        assert merged == jart.merge(a, b)
        assert merged["meta"] == {"from": "a"}
        assert sorted(merged["scenarios"]) == ["s1", "s2", "s3"]
        assert tart.get_metric(merged, "s2", "mrse_qn") == 9.0 == \
            jart.get_metric(merged, "s2", "mrse_qn")
        assert tart.thetas_qn(merged, "s1") == [[1.0, 2.0]] == \
            jart.thetas_qn(merged, "s1")
        with pytest.raises(KeyError, match="stored no thetas"):
            tart.thetas_qn(merged, "s3")
        with pytest.raises(ValueError, match="kind"):
            tart.merge(a, {**b, "kind": "other"})


# ------------------------------------------------------------ the loss

def test_make_loss_fn_matches_reference():
    from repro.configs import get_config as jget_config
    from repro.models.model import Model as JModel
    from repro.train.trainer import make_loss_fn as jmake_loss_fn
    from repro_torch.configs import get_config
    from repro_torch.interop import batch_from_numpy, params_from_reference
    from repro_torch.train import trainer as ttrainer
    cfg = jget_config("glm4-9b", reduced=True)
    jm = JModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    jloss, jaux = jax.jit(jmake_loss_fn(jm))(
        jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    model = params_from_reference(jax.tree_util.tree_map(np.asarray,
                                                         jparams),
                                  get_config("glm4-9b", True), device="cpu")
    loss_fn = ttrainer.make_loss_fn(model)
    with torch.no_grad():
        loss, aux = loss_fn(model.params(), batch_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(aux["ce"].item(), float(jaux["ce"]),
                               rtol=1e-5)


# ---------------------------------------------- registry, wire, mechanism

def test_unregister_removes_a_registered_attack():
    for reg in (jreg, treg):
        reg.register(reg.Attack(name="tmp_zero",
                                corrupt=lambda v, m, **_: v))
        assert "tmp_zero" in reg.registered()
        reg.unregister("tmp_zero")
        assert "tmp_zero" not in reg.registered()
        reg.unregister("tmp_zero")            # absent: a no-op
    import repro_torch.attacks as tattacks
    assert tattacks.unregister is treg.unregister


@pytest.mark.parametrize("tree,single", [
    (np.zeros(3, np.float32), True), ({"w": np.zeros(2, np.float32)}, True),
    ([np.zeros(1, np.float32)], True),
    ({"w": np.zeros(2, np.float32), "b": np.zeros(1, np.float32)}, False),
    ({"a": [np.zeros(1, np.float32), {"c": np.zeros(2, np.float32)}]},
     False),
])
def test_is_single_leaf_matches_reference(tree, single):
    from repro_torch.interop import tree_from_numpy
    assert jtransport.is_single_leaf(jax.tree_util.tree_map(jnp.asarray,
                                                            tree)) == single
    port = tree_from_numpy(tree, device="cpu") if not isinstance(
        tree, np.ndarray) else torch.from_numpy(tree)
    assert ttransport.is_single_leaf(port) == single


def test_add_noise_on_passed_draws_and_a_generator():
    key = jax.random.PRNGKey(3)
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    want = np.asarray(jdp.add_noise(key, jnp.asarray(x), 0.5))
    z = np.array(jax.random.normal(key, x.shape, jnp.float32))
    got = tdp.add_noise(torch.from_numpy(z), torch.from_numpy(x), 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    xt = torch.from_numpy(x)
    drawn = tdp.add_noise(g1, xt, 0.5)
    assert torch.equal(drawn, xt + 0.5 * torch.randn(x.shape, generator=g2))
    assert drawn.dtype == torch.float32


# ------------------------------------------------------------ token stream

def test_token_batches_follow_the_reference_rule():
    from repro_torch.data.synthetic import token_batches
    vocab, batch, seq = 97, 16, 64
    got = list(token_batches(0, vocab, batch, seq, 3, device="cpu"))
    again = list(token_batches(0, vocab, batch, seq, 3, device="cpu"))
    other = next(token_batches(1, vocab, batch, seq, 1, device="cpu"))
    assert len(got) == 3 and not torch.equal(got[0][0], other[0])
    for (x, y), (x2, y2) in zip(got, again):
        assert torch.equal(x, x2) and torch.equal(y, y2)
        assert x.shape == y.shape == (batch, seq) and x.dtype == torch.int64
        assert torch.equal(x[:, 1:], y[:, :-1])        # labels: the shift
        assert int(x.min()) >= 0 and int(y.max()) < vocab
        follow = ((3 * x + 7) % vocab == y).float().mean().item()
        assert 0.85 < follow < 0.95                    # 10% uniform noise
    assert not torch.equal(got[0][0], got[1][0])


# ------------------------------------------------------------ the exports

#: the reference's exports that need no counterpart in the port (ROADMAP A
#: item 1): its Pallas and jit spellings, the vmap machine map
#: (``AllMachines`` stands in) and ``repro.core``'s deprecated shims
NO_COUNTERPART = {
    "agg": {"has_pallas", "ostat_pallas", "dcq_pallas", "dcq_jit"},
    "core": {"vmap_machines", "aggregate", "byzantine"},
    "train": set(),
    "models": set(),
    "analyze": set(),
}


@pytest.mark.parametrize("package", sorted(NO_COUNTERPART))
def test_exports_cover_the_reference(package):
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    missing = set(ref.__all__) - set(port.__all__) - NO_COUNTERPART[package]
    assert not missing, f"repro_torch.{package} lacks {sorted(missing)}"
    assert not NO_COUNTERPART[package] & set(port.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None, name


# --------------------------------------------- the machine model's modules

#: the reference's public names in its machine-model modules whose port
#: counterpart has another name
RENAMED = {
    "launch.dryrun": {"lower_one": "trace_one"},
    "launch.mesh": {"ICI_BW": "NVLINK_BW"},
}
#: ... and those with no counterpart, with the reason
HLO_ONLY = {
    "launch.roofline": {
        "parse_collective_bytes": "reads collective result shapes off "
        "XLA's HLO text; the port's collectives record their bytes",
        "module_costs": "reads XLA's compiled cost and memory analyses",
        "extrapolate_layers": "corrects XLA's scan-once cost analysis; "
        "the port's Python loop over layers is traced whole"},
    "launch.mesh": {},
    "launch.dryrun": {},
    "configs.shapes": {},
}


def _public(mod):
    """The functions and classes a module defines, and the constants it
    assigns at top level (not those it imports)."""
    import inspect
    import re
    src = inspect.getsource(mod)
    return {n for n, v in vars(mod).items() if not n.startswith("_")
            and ((n.isupper() and re.search(rf"^{n}\s*=", src, re.M))
                 or (callable(v) and not inspect.ismodule(v)
                     and getattr(v, "__module__", None) == mod.__name__))}


@pytest.mark.parametrize("module", sorted(HLO_ONLY))
def test_machine_model_names_have_counterparts(module):
    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    names = _public(ref)
    assert names, module
    renamed = RENAMED.get(module, {})
    for name in sorted(names):
        if name in HLO_ONLY[module]:
            assert not hasattr(port, name), name
            continue
        assert hasattr(port, renamed.get(name, name)), \
            f"repro_torch.{module} lacks {renamed.get(name, name)}"
    for name in getattr(port, "__all__", ()):
        assert getattr(port, name) is not None, name
