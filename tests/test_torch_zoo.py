"""The model zoo's entry points in repro_torch against the JAX reference, on
the CPU: the three configs (``xlstm-125m``, ``qwen3-moe-30b-a3b``,
``zamba2-7b``) and their full-width trees, ``TrainScenario`` and the
``zoo-smoke`` preset (ids, JSON, the CLI's seven records with the
reference's spend ledger and ``comm`` record), the serve launcher at its
default arch (its DP ledger leaf for leaf), the train launcher at
``xlstm-125m`` under AdamW and the quasi-Newton step (finite losses, the
reference's checkpoint keys, read back equal), and the facade. The
per-family parity of the models is in tests/test_torch_xlstm.py,
test_torch_moe.py and test_torch_hybrid.py."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sweep as jsweep
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.core import bfgs as jbfgs
from repro.core import transport as jtransport
from repro.models.model import Model as JModel
from repro.sweep.executor import _train_spend_record as jspend
from repro.train import optimizer as jopt
from repro_torch import api, privacy
from repro_torch import sweep as tsweep
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import transport
from repro_torch.core.bfgs import LBFGSMemory
from repro_torch.interop import model_config_from_reference
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.model import Model
from repro_torch.sweep import cli as tcli
from repro_torch.sweep.executor import _train_spend_record
from repro_torch.train.optimizer import AdamW
from torch_threads import share_the_cores  # noqa: F401 (autouse)

NEW = ("xlstm-125m", "qwen3-moe-30b-a3b", "zamba2-7b")
#: full-width trees: leaves and parameters (the reference's Model.init)
FULL = {"xlstm-125m": (103, 190_652_240),
        "qwen3-moe-30b-a3b": (13, 30_532_110_336),
        "zamba2-7b": (20, 6_750_550_224)}


def _paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _ref_shapes(arch, reduced):
    return jax.eval_shape(JModel(jget_config(arch, reduced=reduced)).init,
                          jax.random.PRNGKey(0))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch, reduced):
    ref = jget_config(arch, reduced=reduced)
    port = get_config(arch, reduced=reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert model_config_from_reference(dataclasses.asdict(ref)) == port
    assert port.head_dim == ref.head_dim


def test_registry_holds_the_four_families():
    assert set(NEW + ("glm4-9b",)) < set(ARCHS) and len(ARCHS) == 10
    assert {get_config(a).family for a in ARCHS} == \
        {"dense", "vlm", "audio", "ssm", "moe", "hybrid"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-x")


@pytest.mark.parametrize("arch", NEW)
def test_full_width_tree_without_allocating(arch):
    """The full config's parameters on the meta device: the reference's
    leaf paths, order, shapes and dtypes (jax.eval_shape of its
    Model.init), and its leaf and parameter counts."""
    ref = _ref_shapes(arch, reduced=False)
    tree = Model(get_config(arch), device="meta").params()
    assert transport.leaf_paths(tree) == _paths(ref)
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in transport.tree_leaves(tree)]
    want = [(tuple(s.shape), str(s.dtype))
            for s in jax.tree_util.tree_leaves(ref)]
    assert got == want
    n = sum(t.numel() for t in transport.tree_leaves(tree))
    assert (len(got), n) == FULL[arch]


# ------------------------------------------------------- training scenarios

@pytest.mark.parametrize("accountant", (None,) + privacy.registered())
def test_zoo_smoke_scenarios_match_reference(accountant):
    """Ids, group keys, labels and to_json of the preset and its fast
    variant, under each accountant override; each round-trips through
    JSON."""
    ref, got = jsweep.build_preset("zoo-smoke"), \
        tsweep.build_preset("zoo-smoke")
    if accountant is not None:
        ref = [dataclasses.replace(s, accountant=accountant) for s in ref]
        got = [dataclasses.replace(s, accountant=accountant) for s in got]
    for fast in (False, True):
        r = jsweep.fast_variant(ref) if fast else ref
        g = tsweep.fast_variant(got) if fast else got
        assert len(g) == 7
        assert [s.scenario_id() for s in g] == [s.scenario_id() for s in r]
        assert [s.group_key() for s in g] == [s.group_key() for s in r]
        assert [s.to_json() for s in g] == [s.to_json() for s in r]
        assert [tsweep.group_label(k) for k in tsweep.group_scenarios(g)] \
            == [jsweep.group_label(k) for k in jsweep.group_scenarios(r)]
        for s, rs in zip(g, r):
            assert tsweep.scenario_from_json(s.to_json()) == s
            assert tsweep.scenario_from_json(rs.to_json()) == s
            assert dataclasses.asdict(s.protocol_config()) == \
                dataclasses.asdict(rs.protocol_config())
    assert len(tsweep.group_scenarios(got)) == 6


def test_train_scenario_checks_match_reference():
    fields = [f.name for f in dataclasses.fields(tsweep.TrainScenario)]
    assert fields == [f.name for f in dataclasses.fields(jsweep.TrainScenario)]
    assert dataclasses.asdict(tsweep.TrainScenario()) == \
        dataclasses.asdict(jsweep.TrainScenario())
    s = tsweep.TrainScenario(attack="sign", byz_frac=0.5, batch=12,
                             machines=6)
    assert s.attack == jsweep.TrainScenario(attack="sign").attack
    assert (s.n_byzantine(), s.n_per_machine()) == (3, 2)
    assert tsweep.TrainScenario(arch="llava-next-mistral-7b").arch == \
        "llava-next-mistral-7b"
    for bad in (dict(arch="gpt-x"), dict(batch=9),
                dict(aggregator="nope"), dict(attack="nope"),
                dict(accountant="nope")):
        with pytest.raises(ValueError):
            tsweep.TrainScenario(**bad)


def test_zoo_smoke_runs_on_the_cpu(tmp_path, capsys):
    """``--preset zoo-smoke --fast --device cpu``: seven records (two steps
    each), finite losses where noiseless, and each record's spend (the
    per-leaf ledger) and comm record equal to the reference's
    ``_train_spend_record`` and comm values for the same scenario and its
    Model.init tree."""
    path = str(tmp_path / "zoo.json")
    assert tcli.main(["--preset", "zoo-smoke", "--fast", "--device", "cpu",
                      "--out", path]) == 0
    art = tsweep.load(path)
    assert len(art["scenarios"]) == 7
    out = capsys.readouterr().out
    assert "7 scenario(s) on cpu" in out
    for sid, rec in art["scenarios"].items():
        s = tsweep.scenario_from_json(rec["scenario"])
        js = jsweep.scenario_from_json(rec["scenario"])
        assert s.scenario_id() == sid == js.scenario_id()
        shapes = _ref_shapes(s.arch, reduced=True)
        assert rec["spend"] == jspend(js, shapes)
        p_total = sum(math.prod(x.shape)
                      for x in jax.tree_util.tree_leaves(shapes))
        assert rec["comm"] == {
            "n_transmissions": 5, "bytes_per_round": 4 * p_total,
            "bytes_per_machine": 4 * p_total * 5, "n_params": p_total,
            "eps_per_round": js.eps / 5, "delta_per_round": js.delta / 5}
        m = rec["metrics"]
        assert len(m["losses"]) == 2 == rec["timing"]["steps"]
        assert rec["timing"]["launches"] == 0          # plain forms here
        if s.eps <= 0:
            assert all(map(math.isfinite, m["losses"]))
            assert math.isfinite(m["grad_norm_last"])
        else:
            assert len(rec["spend"]["per_leaf"]) == 5 * len(_paths(shapes))


def test_train_spend_record_matches_reference():
    """Every accountant, noised and noiseless, on the full-width xLSTM
    tree (103 leaves): the port's record equals the reference's."""
    tree = Model(get_config("xlstm-125m"), device="meta").params()
    ref = _ref_shapes("xlstm-125m", reduced=False)
    for acct in privacy.registered():
        for eps in (0.0, 5.0):
            kw = dict(arch="xlstm-125m", eps=eps, accountant=acct)
            assert _train_spend_record(tsweep.TrainScenario(**kw), tree) \
                == jspend(jsweep.TrainScenario(**kw), ref)


# ---------------------------------------------------------------- launchers

def test_serve_launcher_default_arch_ledger_matches_the_reference():
    """Both launchers at their default ``--config`` (xlstm-125m, reduced:
    17 leaves, the layers a list) with ``--machines 8 --rounds 2 --eps 1``:
    the same ledger, leaf for leaf, 2 x 17 records. (The ledger does not
    depend on the rule; median keeps the reference's run short.)"""
    from repro.launch import serve as jlauncher
    argv = ["--machines", "8", "--rounds", "2", "--eps", "1", "--agg",
            "median"]
    ref = jlauncher.main(argv)
    svc = serve_launcher.main(argv + ["--device", "cpu"])
    keys = ("transmission", "leaf", "dim", "sigma")
    want = [tuple(e[k] for k in keys) for e in ref.ledger]
    got = [tuple(e[k] for k in keys) for e in svc.ledger]
    assert len(got) == 2 * 17 and got == want
    assert "xlstm_layers/1/mixer/r_h" in {e["leaf"] for e in svc.ledger}
    assert all(bool(torch.isfinite(t).all())
               for t in transport.tree_leaves(svc.theta))


def _ref_tree():
    shapes = _ref_shapes("xlstm-125m", reduced=True)
    return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize("optimizer", ["adamw", "qn"])
def test_train_launcher_default_arch(optimizer, tmp_path, capsys):
    """``--optimizer adamw|qn`` with no ``--config`` (xlstm-125m) on the
    CPU: finite losses, and a checkpoint under the reference's keys (its
    ``_flatten`` of the tree with list indices, and of its AdamW state or
    L-BFGS memory), which the port restores equal to the file and the
    reference's ``restore`` reads."""
    ck = str(tmp_path / f"{optimizer}.npz")
    losses = train_launcher.main(["--steps", "3", "--seq", "16",
                                  "--optimizer", optimizer, "--byzantine",
                                  "0.25", "--attack", "signflip",
                                  "--device", "cpu", "--ckpt", ck])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(map(math.isfinite, losses))
    assert "xlstm-125m (reduced)" in out and "17 leaves x 3 steps" in out
    jparams = _ref_tree()
    jstate = jbfgs.LBFGSMemory.init_like(5, jparams, machines=4) \
        if optimizer == "qn" else jopt.AdamW().init(jparams)
    want = {f"params/{k}" for k in jckpt._flatten(jparams)} | \
        {f"opt/{k}" for k in jckpt._flatten(jstate)}
    with np.load(ck) as z:
        keys = set(z.files) - {"__step__", "__meta__"}
        raw = {k: z[k].copy() for k in keys}
    assert keys == want and "params/xlstm_layers/0/mixer/w_q" in keys
    model = Model(get_config("xlstm-125m", reduced=True), device="cpu")
    tmpl = LBFGSMemory.init_like(5, model.params(), machines=4) \
        if optimizer == "qn" else AdamW().init(model.params())
    params, state, step, meta = tckpt.restore(ck, model.params(), tmpl)
    assert step == 3 and meta["optimizer"] == optimizer
    for path, t in zip(transport.leaf_paths(params),
                       transport.tree_leaves(params)):
        np.testing.assert_array_equal(t.detach().numpy(),
                                      raw[f"params/{path}"])
    _, jstate2, jstep, _ = jckpt.restore(ck, jparams, jstate)
    assert jstep == 3
    for path, a in jckpt._flatten(jstate2).items():
        np.testing.assert_array_equal(a, raw[f"opt/{path}"])


# ------------------------------------------------------------------ facade

def test_facade_takes_the_new_families():
    """``api.run_sweep`` on a one-step training scenario of each new
    family, and ``api.serve`` around a reduced xLSTM's tree."""
    scens = [tsweep.TrainScenario(arch=a, steps=1, aggregator="median")
             for a in NEW]
    art = api.run_sweep(scens, device="cpu")
    assert len(art["scenarios"]) == 3
    for rec in art["scenarios"].values():
        assert all(map(math.isfinite, rec["metrics"]["losses"]))
    tree = transport.tree_map(torch.Tensor.detach, Model(
        get_config("xlstm-125m", reduced=True), device="cpu").params())
    svc = api.serve(tree, method="median", capacity=4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    svc.submit_many(transport.tree_map(
        lambda x: torch.randn((4,) + tuple(x.shape), generator=gen), tree))
    assert svc.round_idx == 1
    assert transport.leaf_paths(svc.theta) == transport.leaf_paths(tree)
