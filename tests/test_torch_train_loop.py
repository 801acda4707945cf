"""The robust-DP training loop of repro_torch on the CPU: the reference's
own tests/test_train.py properties, checked on the reduced glm4-9b (the
reference's tests use xlstm-125m, whose launcher runs are in
tests/test_torch_zoo.py), the launcher (``python -m
repro_torch.launch.train``) with its refusals and exit codes, and the
port's import boundary. The parity of each piece with
the reference is in tests/test_torch_train.py. The training properties
keep the reference's thresholds over 12 and 16 steps where it takes 30
and 25 (each plain dcq step on the CPU costs ~0.25 s).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import transport
from repro_torch.data import lm as tlm
from repro_torch.dist import grad_agg as tga
from repro_torch.launch import train as launcher
from repro_torch.models.model import Model as TModel
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ARCH = "glm4-9b"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------ the reference's test_train properties

def _batch(cfg, seed, B=8, S=32):
    return tlm.make_batch(torch.Generator().manual_seed(seed), cfg, B, S)


@pytest.fixture(scope="module")
def port_setup():
    cfg = get_config(ARCH, reduced=True)
    return cfg, TModel(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))


def _fresh(port_setup):
    cfg, model = port_setup
    m = TModel(cfg, device="meta")
    m.load_state_dict({k: v.clone() for k, v in model.state_dict().items()},
                      assign=True)
    return m


def test_mean_agg_equals_plain_dataparallel(port_setup):
    cfg, _ = port_setup
    model = _fresh(port_setup)
    batch = _batch(cfg, 1)
    opt = topt.SGD(lr=0.1, momentum=0.0)
    base = transport.tree_map(lambda p: p.detach().clone(), model.params())
    step = ttrainer.make_train_step(model, opt, ttrainer.TrainConfig(
        n_machines=4, agg=tga.GradAggConfig(method="mean")))
    p1, _, _ = step(model.params(), opt.init(model.params()), batch)
    # one global gradient step: the loss is the mean over machines
    leaves = [p.requires_grad_() for p in transport.tree_leaves(base)]
    tree = transport.tree_unflatten(transport.tree_flatten(base)[1], leaves)
    loss = torch.stack([model.loss({k: v[2 * i:2 * i + 2]
                                    for k, v in batch.items()},
                                   params=tree)[0] for i in range(4)]).mean()
    grads = transport.tree_unflatten(transport.tree_flatten(base)[1],
                                     torch.autograd.grad(loss, leaves))
    upd, _ = opt.update(grads, opt.init(tree), tree)
    p2 = topt.apply_updates(tree, upd)
    for a, b in zip(transport.tree_leaves(p1), transport.tree_leaves(p2)):
        assert (a - b).abs().max().item() < 1e-5


def _fit(port_setup, agg, steps, lr=3e-3, mask=None):
    cfg, _ = port_setup
    model = _fresh(port_setup)
    trainer = ttrainer.Trainer(model, topt.AdamW(lr=lr), ttrainer.TrainConfig(
        n_machines=4, agg=agg))
    losses = []
    trainer.fit(model.params(), tlm.synthetic_lm_batches(
        torch.Generator().manual_seed(1), cfg, steps, 8, 32),
        torch.Generator().manual_seed(2), byz_mask=mask,
        callback=lambda i, m: losses.append(m["loss"].item()))
    return losses


def test_training_reduces_loss(port_setup):
    losses = _fit(port_setup, tga.GradAggConfig(method="dcq"), 12)
    assert losses[-1] < losses[0] - 0.1


def test_byzantine_training_dcq_survives_mean_does_not(port_setup):
    mask = torch.tensor([True, False, False, False])
    final = {m: _fit(port_setup, tga.GradAggConfig(
        method=m, attack="scale", attack_factor=-3.0), 16, mask=mask)[-1]
        for m in ("dcq", "mean")}
    assert final["dcq"] < final["mean"] - 0.05


def test_microbatch_accumulation_matches(port_setup):
    cfg, _ = port_setup
    batch = _batch(cfg, 5)
    opt = topt.SGD(lr=0.1, momentum=0.0)
    agg = tga.GradAggConfig(method="mean")
    out = []
    for mb in (0, 2):
        model = _fresh(port_setup)
        step = ttrainer.make_train_step(model, opt, ttrainer.TrainConfig(
            n_machines=2, microbatch=mb, agg=agg))
        p, _, _ = step(model.params(), opt.init(model.params()), batch)
        out.append(p)
    for a, b in zip(*(transport.tree_leaves(p) for p in out)):
        assert (a - b).abs().max().item() < 1e-4


def test_trainer_refusals(port_setup):
    """fsdp is a no-op without a mesh and on a machine mesh (as in the
    reference) and refused where "data" carries the machine axis; both
    trainers take a model axis and slice the leaves the rules put on it.
    (The trainers on ranks: tests/test_torch_dist_ranks.py; the plans on
    every mesh kind: tests/test_torch_dist.py.)"""
    cfg, _ = port_setup
    batch = _batch(cfg, 3)
    opt = topt.SGD(lr=0.1, momentum=0.0)
    from repro_torch.launch.cli import sharded_run
    out = []
    for fsdp, sharded in ((False, False), (True, False), (True, True)):
        model = _fresh(port_setup)
        with sharded_run(4, "cpu", sharded) as mesh:
            step = ttrainer.make_train_step(model, opt, ttrainer.TrainConfig(
                fsdp=fsdp, agg=tga.GradAggConfig(method="median")), mesh)
            p, _, _ = step(model.params(), opt.init(model.params()), batch)
        out.append(transport.tree_leaves(p))
    for leaves in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], leaves))
    # a model axis is accepted by both trainers: each leaf the rules put
    # on "model" is held as a half (the reduced glm4-9b's dims divide by 2:
    # embed, lm_head and the seven block matrices)
    model = _fresh(port_setup)
    tr = ttrainer.Trainer(model, topt.AdamW(), ttrainer.TrainConfig(),
                          mesh={"data": 2, "model": 2})
    half = tr.payload.shard(model.params())
    for path, a, b in zip(transport.leaf_paths(half),
                          transport.tree_leaves(half),
                          transport.tree_leaves(model.params())):
        d = tr.payload.by_path[path]
        assert a.numel() * (1 if d is None else 2) == b.numel(), path
    assert sum(d is not None for d in tr.payload.dims) == 9
    with pytest.raises(ValueError, match="machine axis"):
        ttrainer.make_train_step(model, topt.AdamW(), ttrainer.TrainConfig(
            fsdp=True), mesh={"data": 4})
    step = ttrainer.make_qn_train_step(model, ttrainer.QNTrainConfig(),
                                       mesh={"machines": 2, "model": 2})
    assert step.payload.dims == tr.payload.dims
    qn = ttrainer.QNTrainer(model, ttrainer.QNTrainConfig(),
                            mesh={"pod": 2, "data": 2, "model": 2})
    assert qn.world == 4 and qn.payload.dims == tr.payload.dims


# ------------------------------------------------------------- launcher

@pytest.mark.parametrize("argv,code,says", [
    ([], 1, "device='cpu'"),                    # xlstm-125m: no card here
    (["--config", "glm4-9b", "--optimizer", "qn"], 1, "device='cpu'"),
    (["--config", "glm4-9b", "--sharded"], 1, "device='cpu'"),
    (["--config", "glm4-9b", "--optimizer", "qn", "--sharded"], 1,
     "device='cpu'"),
    (["--optimizer", "qn"], 1, "device='cpu'"),         # xlstm-125m
    (["--config", "llava-next-mistral-7b"], 1, "device='cpu'"),   # runs
    (["--config", "mistral-large-123b"], 1, "device='cpu'"),
    (["--config", "gpt-x"], 2, "unknown arch"),
    (["--config", "glm4-9b"], 1, "device='cpu'"),       # no card here
])
def test_launcher_refusals(argv, code, says, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        launcher.main(argv)
    assert exc.value.code == code
    assert says in capsys.readouterr().err


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    losses = launcher.main(["--config", "glm4-9b", "--steps", "4",
                            "--seq", "32", "--agg", "dcq", "--eps", "1",
                            "--byzantine", "0.25", "--attack", "signflip",
                            "--device", "cpu", "--ckpt", ck])
    out = capsys.readouterr().out
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert "12 leaves x 4 steps" in out and "12 leaf records" in out
    with np.load(ck) as z:
        assert int(z["__step__"]) == 4 and "opt/.nu/embed" in z.files


def test_port_imports_no_jax():
    """Every module of repro_torch imports in a fresh interpreter without
    pulling in jax or the JAX package."""
    code = ("import importlib, pkgutil, sys; import repro_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.') if not m.name.endswith('__main__')]; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro'); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=False)
    assert res.returncode == 0, res.stdout + res.stderr
