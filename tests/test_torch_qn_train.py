"""The quasi-Newton trainer of repro_torch against the JAX reference, on
the CPU: ``make_qn_train_step`` and ``QNTrainer`` on the reduced glm4-9b
(f32, 12 stacked leaves) from the reference's own ``Model.init``
parameters and ``make_batch`` tokens, the launcher's ``--optimizer qn``
and the checkpoint of the L-BFGS memory under the reference's keys.

The reference's steps are its ``protocol_tree_rounds`` called as its
``make_qn_train_step`` calls it, jitted (its aggregation runs its plain
jnp forms at these shapes, as its dispatch table says); the port runs its
plain forms on the CPU with the reference's DCQ knots handed in (ROADMAP
C). Each step starts from the state the reference's step started from,
so its gap is its own: three steps noiseless with machine 0 signflipped,
then two with every sigma overridden to 1e-3 (``sigmas=``) on the
reference's own draws, for the median and for dcq_mad. The median:
parameters and the memory within atol = rtol = 1e-4 (curvature amplifies
f32 sums in another order: rho = 1/(s.y)). dcq_mad: the memory on 99.99%
of the coordinates at every step, the parameters at the first step (an
empty memory); DCQ at m = 4 is discontinuous, and with a fuller memory the
two-loop spreads one flipped coordinate of g_os into every machine's
direction (ROADMAP C). Losses within rtol 1e-5 and counts equal at every
step. The grad norm within rtol 1e-5 of the exact (float64) norm of the
reference's own g_cq, rebuilt here by its R2 (its f32 norm is the one the
reference reports): the reference's f32 ``vdot`` on the CPU reads ~1e-3
below the exact inner product (``test_qn_train_step_matches_reference``
prints both gaps; ROADMAP C).
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.configs.base import TreeProtocolConfig as JTreeCfg
from repro.core import bfgs as jbfgs
from repro.core import transport as jtransport
from repro.core.protocol import protocol_tree_rounds as jrounds
from repro.data import lm as jlm
from repro.models.model import Model as JModel
from repro.train import trainer as jtrainer
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.configs.base import TreeProtocolConfig
from repro_torch.core import dp, transport
from repro_torch.core.bfgs import LBFGSMemory
from repro_torch.core.protocol import protocol_tree_rounds
from repro_torch.interop import (batch_from_numpy,
                                 lbfgs_memory_from_reference,
                                 params_from_reference,
                                 tree_draws_from_numpy, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.launch import train as launcher
from repro_torch.train import trainer as ttrainer
from test_torch_qn import ref_knots, reference_draws  # noqa: F401
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ARCH = "glm4-9b"
M = 4
NOISELESS, NOISED = 3, 2
SIGMA = 1e-3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=["median", "dcq_mad"])
def ref_run(request):
    """The reference's steps on its parameters (``Model.init``) and
    batches of 8 x 16 tokens (``make_batch``), machine 0 signflipped, the
    aggregator of the fixture's parameter: NOISELESS steps of its engine as
    its ``make_qn_train_step`` runs it, then NOISED ones at every sigma
    SIGMA on the draws of their keys, each from the one before. Each step
    records where it started (``start``: None for the initial parameters
    and an empty memory, else the step whose result it continues), whether
    it was noised, its result, and the norm of its g_cq in float32 as the
    reference reports it and in float64 (``grad_norm_exact``), from its R2
    rebuilt on its theta_cq with its keys."""
    agg = request.param
    cfg = jget_config(ARCH, reduced=True)
    jm = JModel(cfg)
    init = jm.init(jax.random.PRNGKey(0))
    batches = [jlm.make_batch(jax.random.PRNGKey(10 + i), cfg, 8, 16)
               for i in range(NOISELESS + NOISED)]
    mask = jnp.arange(M) < 1
    qcfg = jtrainer.QNTrainConfig(n_machines=M, attack="signflip",
                                  protocol=JTreeCfg(aggregator=agg))
    empty = jtrainer.QNTrainer(jm, qcfg).init_memory(init)
    sigmas = {name: SIGMA for name in dp.TREE_TRANSMISSIONS}
    loss_fn = jtrainer.make_loss_fn(jm, qcfg.remat)

    def grad_fn(p, b):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, b)
        return loss, g

    def split(batch):
        return jax.tree_util.tree_map(
            lambda x: x.reshape((M, x.shape[0] // M) + x.shape[1:]), batch)

    @functools.partial(jax.jit, static_argnums=4)
    def engine(p, mm, batch, key, loud):
        tcfg = JTreeCfg(eps=1.0, aggregator=agg) if loud else qcfg.protocol
        return jrounds(key, p, split(batch), grad_fn, tcfg, mem=mm,
                       byz_mask=mask, attack=qcfg.attack,
                       attack_factor=qcfg.attack_factor,
                       sigmas=sigmas if loud else None, n=2)

    @jax.jit
    def g_cq(theta_cq, batch, key, sigma):
        """The engine's R2 (sigma 0 adds nothing: the noiseless wire)."""
        keys = jax.random.split(key, 16)
        g_j = jax.vmap(lambda b: grad_fn(theta_cq, b)[1])(split(batch))
        v = jtransport.wire_noise(keys[2], g_j, sigma)
        v = jtransport.wire_corrupt(keys[3], v, mask, attack="signflip",
                                    round_idx=1)
        g = jtransport.wire_aggregate(v, method=agg, K=10, trim_beta=0.2)
        return g, jnp.sqrt(jtransport.tree_dot(g, g))
    steps, states = [], []
    for i in range(NOISELESS + NOISED):
        start, loud = (i - 1 if i else None), i >= NOISELESS
        params, mem = (init, empty) if start is None else states[start]
        key = jax.random.PRNGKey(100 + i)
        rec = {"start": start, "noised": loud, "batch": _np(batches[i])}
        res = engine(params, mem, batches[i], key, loud)
        if loud:
            rec["draws"] = reference_draws(key, params, M)[0]
        g, norm32 = g_cq(res.theta_cq, batches[i], key,
                         SIGMA if loud else 0.0)
        # the rebuilt R2 is the engine's: its f32 norm is the one reported
        np.testing.assert_allclose(float(norm32), float(res.grad_norm),
                                   rtol=1e-6)
        exact = math.sqrt(sum(float(np.dot(x.ravel(), x.ravel())) for x in
                              (np.asarray(y, np.float64) for y in
                               jax.tree_util.tree_leaves(g))))
        states.append((res.theta_qn, res.mem))
        rec.update(loss=float(res.losses.mean()),
                   grad_norm=float(res.grad_norm), grad_norm_exact=exact,
                   params=_np(res.theta_qn), mem=_np(res.mem))
        steps.append(rec)
    return {"agg": agg, "init": _np(init), "steps": steps}


def _port_model(ref_run):
    return params_from_reference(ref_run["init"], get_config(ARCH, True),
                                 device="cpu")


def _close_trees(got, want, exact: bool, tol=1e-4):
    """Every coordinate within atol = rtol = ``tol`` (``exact``), or 99.99%
    of them (DCQ at m = 4)."""
    got = transport.tree_leaves(tree_to_numpy(got))
    want = [np.asarray(b, np.float32) for b in
            jax.tree_util.tree_leaves(want)]
    assert len(got) == len(want)
    close = total = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if exact:
            np.testing.assert_allclose(a, b, atol=tol, rtol=tol)
        close += int(np.isclose(a, b, atol=tol, rtol=tol).sum())
        total += a.size
    assert close >= 0.9999 * total, f"{total - close} of {total} apart"


def test_qn_train_step_matches_reference(ref_run, ref_knots, capsys):
    """Each step from the state the reference's started from (the
    initial one, or the reference's result of the step before), so each
    step's gap is its own: over several steps the curvature amplifies
    f32 differences (rho = 1/(s.y)). dcq_mad's parameters are held on the
    first step only, where the memory is empty. Prints each step's grad
    norm gap to the exact norm, the port's and the reference's (``-s``)."""
    exact = ref_run["agg"] == "median"
    model = _port_model(ref_run)
    init = transport.tree_map(lambda x: x.detach().clone(), model.params())
    mask = torch.arange(M) < 1
    sigmas = {name: SIGMA for name in dp.TREE_TRANSMISSIONS}
    steps = {loud: ttrainer.make_qn_train_step(model, ttrainer.QNTrainConfig(
        n_machines=M, attack="signflip", protocol=TreeProtocolConfig(
            eps=1.0 if loud else 0.0, aggregator=ref_run["agg"])))
        for loud in (False, True)}
    gaps = []
    for want in ref_run["steps"]:
        if want["start"] is None:
            model.load_params(init)
            mem = LBFGSMemory.init_like(5, model.params(), machines=M)
        else:
            prev = ref_run["steps"][want["start"]]
            model.load_params(tree_from_numpy(prev["params"], "cpu"))
            mem = lbfgs_memory_from_reference(prev["mem"], "cpu")
        kw = {}
        if want["noised"]:
            kw = dict(sigmas=sigmas,
                      noise=tree_draws_from_numpy(want["draws"], "cpu"))
        params, mem, met = steps[want["noised"]](
            model.params(), mem, batch_from_numpy(want["batch"], "cpu"),
            None, mask, **kw)
        assert met["loss_per_machine"].shape == (M,)
        np.testing.assert_allclose(met["loss"].item(), want["loss"],
                                   rtol=1e-5)
        exact_norm = want["grad_norm_exact"]
        gaps.append((met["grad_norm"].item() / exact_norm - 1,
                     want["grad_norm"] / exact_norm - 1))
        np.testing.assert_allclose(met["grad_norm"].item(), exact_norm,
                                   rtol=1e-5)
        if exact or want["start"] is None:
            _close_trees(params, want["params"], exact)
        np.testing.assert_array_equal(mem.count.numpy(),
                                      np.asarray(want["mem"].count))
        _close_trees(mem.s_hist, want["mem"].s_hist, exact)
        _close_trees(mem.y_hist, want["mem"].y_hist, exact)
        # the parameters the model holds are the step's
        assert transport.tree_leaves(model.params())[0] is \
            transport.tree_leaves(params)[0]
    with capsys.disabled():
        print(f"\n{ref_run['agg']}: grad norm / exact norm - 1 per step "
              f"(port, reference f32): {gaps}")


def test_qn_trainer_fit_equals_its_steps(ref_run):
    """``QNTrainer.fit`` over the batches is as many calls of the step
    from an empty memory, on the same generator's draws."""
    batches = [batch_from_numpy(b, "cpu")
               for b in [s["batch"] for s in ref_run["steps"]][:3]]
    qcfg = ttrainer.QNTrainConfig(n_machines=M, attack="gauss",
                                  protocol=TreeProtocolConfig(hist=2))
    mask = torch.arange(M) < 1
    a, b = _port_model(ref_run), _port_model(ref_run)
    trainer = ttrainer.QNTrainer(a, qcfg)
    seen = []
    pa, mem_a, hist = trainer.fit(a.params(), batches,
                                  torch.Generator().manual_seed(7),
                                  byz_mask=mask, callback=lambda i, m:
                                  seen.append(m["loss"].item()))
    step = ttrainer.make_qn_train_step(b, qcfg)
    pb, mem_b = b.params(), trainer.init_memory(b.params())
    gen = torch.Generator().manual_seed(7)
    losses = []
    for batch in batches:
        pb, mem_b, met = step(pb, mem_b, batch, gen, mask)
        losses.append(met["loss"].item())
    assert seen == losses
    assert [h["step"] for h in hist] == list(range(len(batches)))
    for x, y in zip(transport.tree_leaves(pa), transport.tree_leaves(pb)):
        assert torch.equal(x, y)
    assert torch.equal(mem_a.count, mem_b.count)
    assert tuple(mem_a.count.shape) == (M,)
    for x, y in zip(transport.tree_leaves(mem_a.y_hist),
                    transport.tree_leaves(mem_b.y_hist)):
        assert torch.equal(x, y)


def test_qn_launcher_and_checkpoint_keys(tmp_path, capsys):
    """``--optimizer qn --device cpu``: three steps, no B1 launch on the
    CPU, and a checkpoint under the reference's keys (its ``_flatten`` of
    an ``LBFGSMemory``: opt/0 s_hist, opt/1 y_hist, opt/2 count), which
    the reference's own ``restore`` and the port's read back."""
    ck = str(tmp_path / "qn.npz")
    losses = launcher.main(["--config", ARCH, "--steps", "3", "--seq", "32",
                            "--optimizer", "qn", "--machines", "4",
                            "--byzantine", "0.25", "--attack", "signflip",
                            "--device", "cpu", "--ckpt", ck])
    out = capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "opt=qn" in out
    assert "B1 launches 0 (5 transmissions x 12 leaves x 3 steps)" in out
    cfg = jget_config(ARCH, reduced=True)
    jparams = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                     jparams)
    jmem = jbfgs.LBFGSMemory.init_like(5, jparams, machines=4)
    want = {f"params/{k}" for k in jckpt._flatten(jparams)} | \
        {f"opt/{k}" for k in jckpt._flatten(jmem)}
    with np.load(ck) as z:
        keys = set(z.files) - {"__step__", "__meta__"}
        assert keys == want
        assert "opt/2" in keys and "opt/0/layers/attn/w_q" in keys
        assert z["opt/2"].dtype == np.int32 and z["opt/2"].shape == (4,)
        assert z["opt/1/embed"].shape == (4, 5) + jparams["embed"].shape
        count = z["opt/2"].copy()
    assert (count >= 0).all() and (count <= 3).all() and count.max() > 0
    # the reference writes the same keys for its QNTrainer's memory
    ref_ck = str(tmp_path / "ref.npz")
    jckpt.save(ref_ck, jparams, jtrainer.QNTrainer(
        JModel(cfg), jtrainer.QNTrainConfig()).init_memory(jparams), step=3)
    with np.load(ref_ck) as z:
        assert set(z.files) - {"__step__", "__meta__"} == want
    # both packages restore the port's file into their templates
    _, jm2, step, meta = jckpt.restore(ck, jparams, jmem)
    assert step == 3 and meta["optimizer"] == "qn"
    np.testing.assert_array_equal(np.asarray(jm2.count), count)
    model = params_from_reference(_np(jparams), get_config(ARCH, True),
                                  device="cpu")
    tmem = LBFGSMemory.init_like(5, model.params(), machines=4)
    params, mem, step, _ = tckpt.restore(ck, model.params(), tmem)
    assert isinstance(mem, LBFGSMemory) and step == 3
    np.testing.assert_array_equal(mem.count.numpy(), count)
    for a, b in zip(transport.tree_leaves(mem.s_hist),
                    jax.tree_util.tree_leaves(jm2.s_hist)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_qn_checkpoint_round_trips(ref_run, tmp_path):
    """One QN step, saved and restored by the port: parameters and the
    memory come back equal, in their dtypes."""
    model = _port_model(ref_run)
    trainer = ttrainer.QNTrainer(model, ttrainer.QNTrainConfig(
        n_machines=M, attack="signflip"))
    params, mem, _ = trainer.fit(
        model.params(), [batch_from_numpy(ref_run["steps"][0]["batch"], "cpu")],
        byz_mask=torch.arange(M) < 1)
    ck = str(tmp_path / "one.npz")
    tckpt.save(ck, params, mem, step=1)
    blank = _port_model(ref_run)
    p2, m2, step, _ = tckpt.restore(ck, blank.params(),
                                    trainer.init_memory(blank.params()))
    assert step == 1
    for tree_a, tree_b in ((params, p2), (mem.s_hist, m2.s_hist),
                           (mem.y_hist, m2.y_hist)):
        for a, b in zip(transport.tree_leaves(tree_a),
                        transport.tree_leaves(tree_b)):
            assert a.dtype == b.dtype and torch.equal(a.detach(), b)
    assert m2.count.dtype == torch.int32 and torch.equal(mem.count,
                                                         m2.count)


def test_qn_config_defaults_match_reference():
    ref = jtrainer.QNTrainConfig()
    port = ttrainer.QNTrainConfig()
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("agg", ["median", "dcq_mad"])
def test_steps_under_gradient_rounding(agg):
    """How far a QN step moves when every machine gradient moves by 2e-7
    of its leaf's largest magnitude (the order of the card's gradients
    against the CPU's, chip_smoke phase 17): three steps of the reduced
    glm4-9b (8 x 128 tokens, hist 5, sigmas 1e-3, machine 0 signflipped),
    each perturbed and unperturbed from the same state. The median is
    continuous: every coordinate of the parameters and the memory within
    1e-4. dcq_mad at m = 4 is not, and the two-loop carries one flipped
    coordinate of g_os into every direction of R5: theta_cq and theta_os
    within 1e-4 on 99.99% of the coordinates, theta_qn and the memory on
    99.9% (chip_smoke phase 20's gates)."""
    from repro_torch.data.lm import make_batch
    from repro_torch.models.model import Model
    cfg = get_config(ARCH, reduced=True)
    gen = torch.Generator().manual_seed(1717)
    model = Model(cfg, device="cpu", generator=gen, remat=True)
    theta = transport.tree_map(lambda x: x.detach().clone(), model.params())
    grad_fn = ttrainer.make_grad_fn(model)
    wobble = torch.Generator().manual_seed(5)

    def rounded(t, b):
        loss, g = grad_fn(t, b)
        return loss, transport.tree_map(
            lambda x: x + 2e-7 * x.abs().max() * torch.randn(
                x.shape, generator=wobble), g)
    qcfg = TreeProtocolConfig(eps=1.0, aggregator=agg)
    mem = LBFGSMemory.init_like(qcfg.hist, theta, machines=M)
    for _ in range(3):
        batch = make_batch(gen, cfg, 8, 128)
        mb = {k: v.reshape((M, 2) + tuple(v.shape[1:]))
              for k, v in batch.items()}
        noise = {name: transport.tree_map(
            lambda p: torch.randn((M,) + tuple(p.shape), generator=gen),
            theta) for name in dp.TREE_TRANSMISSIONS}
        kw = dict(byz_mask=torch.arange(M) < 1, attack="signflip",
                  sigmas={name: SIGMA for name in dp.TREE_TRANSMISSIONS},
                  noise=noise)
        a = protocol_tree_rounds(None, theta, mb, grad_fn, qcfg,
                                 mem=mem.clone(), **kw)
        b = protocol_tree_rounds(None, theta, mb, rounded, qcfg,
                                 mem=mem.clone(), **kw)
        assert torch.equal(a.mem.count, b.mem.count)
        for f, share in (("theta_cq", 0.9999), ("theta_os", 0.9999),
                         ("theta_qn", 0.999), ("s_hist", 0.999),
                         ("y_hist", 0.999)):
            x, y = ((getattr(a.mem, f), getattr(b.mem, f)) if "hist" in f
                    else (getattr(a, f), getattr(b, f)))
            pairs = list(zip(transport.tree_leaves(x),
                             transport.tree_leaves(y)))
            close = sum(int(torch.isclose(x, y, atol=1e-4, rtol=1e-4).sum())
                        for x, y in pairs)
            total = sum(x.numel() for x, _ in pairs)
            assert close == total if agg == "median" else \
                close >= share * total, (f, total - close)
        theta, mem = a.theta_qn, a.mem
