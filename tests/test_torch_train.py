"""Robust DP training: repro_torch's forward/loss, gradient wire,
optimizers, trainer, LM data, checkpoints and launcher against the JAX
reference, on the CPU.

Parameters (``Model.init``'s tree and scales) and tokens are drawn by
numpy from a seed; the wire's noise is the reference's own ``jax.random``
draws, rebuilt from its keys and handed across, since torch cannot
reproduce ``jax.random``. Where the reference would reach a Pallas kernel
it runs its plain version (``use_pallas=False``). The model is the
reduced glm4-9b (2 layers, d_model 256, vocab 512) in f32. The
reference's own tests/test_train.py properties, the launcher and the
import boundary are in tests/test_torch_train_loop.py.

Tolerances: logits, losses and per-machine gradients atol = rtol = 1e-5
(f32 sums in another order); optimizers 1e-6 relative; sigmas and ledgers
bit-equal; the robust aggregates 2e-5 (the quantile knots' float32 ndtri
differs by up to 3 ulp between the packages; the median is exact); three
trainer steps as chip_smoke's card-against-CPU phase: losses rtol 1e-4,
parameters within 1e-5 on at least 99.99% of coordinates and within
2 * lr * steps on all (AdamW's first steps move a coordinate by about
lr * sign(g), so a near-zero aggregate whose sign differs moves it by up
to 2 * lr).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.core import transport as jtransport
from repro.data import lm as jlm
from repro.dist import grad_agg as jga
from repro.models import flash as jflash
from repro.models.model import Model as JModel
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.core import transport
from repro_torch.data import lm as tlm
from repro_torch.dist import grad_agg as tga
from repro_torch.interop import (batch_from_numpy, opt_state_from_reference,
                                 params_from_reference, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.models import flash as tflash
from repro_torch.models.blocks import layer_view
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ARCH = "glm4-9b"
ATOL = RTOL = 1e-5
M = 4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves_np(tree):
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def _tleaves_np(tree):
    return [x for x in transport.tree_leaves(tree_to_numpy(tree))]


def _np_params(jm, seed):
    """Parameters of ``Model.init``'s tree and scales drawn by numpy:
    norms 1, embed and lm_head 0.02, a layer matrix 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return jnp.ones(s.shape, s.dtype)
        scale = 0.02 if s.ndim == 2 else s.shape[-2] ** -0.5
        return jnp.asarray(scale * rng.standard_normal(s.shape), s.dtype)
    return jax.tree_util.tree_map_with_path(
        draw, jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


def _np_batch(rng, B, S, vocab):
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": jnp.asarray(toks[:, :-1]),
            "labels": jnp.asarray(toks[:, 1:])}


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced glm4-9b, numpy-drawn parameters and one
    batch of 8 x 32 numpy tokens."""
    cfg = jget_config(ARCH, reduced=True)
    jm = JModel(cfg)
    return cfg, jm, _np_params(jm, 0), _np_batch(np.random.default_rng(1),
                                                 8, 32, cfg.vocab)


MASK = (np.arange(32)[None] % 3 != 0).repeat(8, 0).astype(np.float32)


@pytest.fixture(scope="module")
def ref_out(ref):
    """The reference's logits, loss and aux, and its loss under MASK, in
    one compiled call."""
    cfg, jm, jparams, batch = ref

    def run(p, b, mask):
        return (jm.forward(p, b)[0], jm.loss(p, b),
                jm.loss(p, {**b, "mask": mask})[0])
    return jax.jit(run)(jparams, batch, jnp.asarray(MASK))


def _port(ref):
    cfg, _, jparams, batch = ref
    model = params_from_reference(_np(jparams), get_config(ARCH, True),
                                  device="cpu")
    return model, batch_from_numpy(_np(batch), device="cpu")


# ---------------------------------------------------------- forward / loss

def test_params_tree_is_the_reference_layout(ref):
    model, _ = _port(ref)
    tree = model.params()
    assert transport.leaf_paths(tree) == jtransport.leaf_paths(ref[2])
    assert {id(x) for x in transport.tree_leaves(tree)} == \
        {id(x) for x in model.parameters()}
    # the tree is the parameters themselves: a write reaches the model
    with torch.no_grad():
        tree["layers"]["attn"]["w_q"][1, 0, 0] = 7.0
    layer1 = layer_view(model.layers.tree(), 1)
    assert layer1.attn.w_q[0, 0].item() == 7.0
    # and a tree of the same shape writes back
    other = tree_from_numpy(_np(ref[2]), device="cpu")
    model.load_params(other)
    assert torch.equal(layer_view(model.layers.tree(), 1).attn.w_q,
                       other["layers"]["attn"]["w_q"][1])
    with pytest.raises(ValueError, match="shape"):
        model.load_params({**other, "norm_f": torch.ones(3)})


def test_forward_and_loss_match_reference(ref, ref_out):
    model, tb = _port(ref)
    jlogits, (jloss, jaux), _ = ref_out
    with torch.no_grad():
        logits, aux = model(tb)
        loss, parts = model.loss(tb)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL,
                               rtol=RTOL)
    assert float(aux) == float(jaux["aux"]) == 0.0
    np.testing.assert_allclose(parts["ce"].item(), float(jaux["ce"]),
                               rtol=RTOL)


def test_masked_cross_entropy_and_remat(ref, ref_out):
    model, tb = _port(ref)
    jloss = ref_out[2]
    loss, _ = model.loss({**tb, "mask": torch.from_numpy(MASK)})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    # remat changes memory, not numbers
    g0 = torch.autograd.grad(model.loss(tb)[0], list(model.parameters()))
    model.remat = True
    g1 = torch.autograd.grad(model.loss(tb)[0], list(model.parameters()))
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


ATTN_CASES = [dict(causal=True), dict(causal=True, window=7),
              dict(causal=False), dict(causal=True, q_offset=9)]


@pytest.mark.parametrize("kw", ATTN_CASES)
def test_flash_attention_matches_reference_f32(kw):
    rng = np.random.default_rng(7)
    S = 24 if kw.get("q_offset") else 33
    q = rng.standard_normal((2, S, 8, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 33, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jax.jit(functools.partial(
        jflash.flash_attention, q_chunk=8, kv_chunk=16, **kw))(q, k, v))
    oracle = np.asarray(jax.jit(functools.partial(
        jflash.attention_reference, **kw))(q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, **kw).numpy()
    plain = tflash.attention_reference(tq, tk, tv, **kw).numpy()
    for a in (got, plain):
        np.testing.assert_allclose(a, want, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(a, oracle, atol=ATOL, rtol=RTOL)


def test_flash_attention_bf16_tolerance():
    """bf16: the reference rounds the probabilities to bf16 before PV,
    SDPA keeps them in f32. Outputs of size ~1 agree within 2^-6 (two bf16
    ulps at 1.0 plus the probability rounding), the port's oracle (which
    rounds as the reference does) within 2^-7 of the reference's."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 40, 8, 32), (2, 40, 2, 32), (2, 40, 2, 32)))
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax.jit(jflash.flash_attention)(*jb), np.float32)
    got = tflash.flash_attention(*tb).float().numpy()
    plain = tflash.attention_reference(*tb).float().numpy()
    np.testing.assert_allclose(got, want, atol=2.0 ** -6, rtol=2.0 ** -6)
    np.testing.assert_allclose(plain, np.asarray(jax.jit(
        jflash.attention_reference)(*jb), np.float32), atol=2.0 ** -7,
        rtol=2.0 ** -7)


# --------------------------------------------------- per-machine gradients

@pytest.fixture(scope="module")
def ref_grads(ref):
    """The reference's per-machine losses and gradients:
    jax.vmap(jax.grad) over M machines of the fixture's batch."""
    cfg, jm, jparams, batch = ref
    mb = jax.tree_util.tree_map(
        lambda x: x.reshape((M, x.shape[0] // M) + x.shape[1:]), batch)

    def one(b):
        (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(jparams, b)
        return loss, g
    losses, grads = jax.jit(jax.vmap(one))(mb)
    return np.asarray(losses), _np(grads)


def test_machine_grads_match_vmap_grad(ref, ref_grads):
    model, tb = _port(ref)
    losses, grads = ttrainer.machine_grads(
        model, model.params(), tb, ttrainer.TrainConfig(n_machines=M))
    np.testing.assert_allclose(losses.numpy(), ref_grads[0], atol=ATOL,
                               rtol=RTOL)
    assert transport.leaf_paths(grads) == jtransport.leaf_paths(ref_grads[1])
    for a, b in zip(_tleaves_np(grads), _leaves_np(ref_grads[1])):
        assert a.shape == b.shape and a.shape[0] == M
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------- the grad wire

def _wire_draws(tree, key, n_leaves):
    """The reference's robust_aggregate draws for ``key``: per-leaf attack
    normals (corrupt_machines always splits) and noise normals
    (transport._leaf_keys)."""
    k_attack, k_noise = jax.random.split(key)
    leaves = jax.tree_util.tree_leaves(tree)
    treedef = jax.tree_util.tree_structure(tree)
    att = [np.asarray(jax.random.normal(k, x.shape, x.dtype))
           for k, x in zip(jax.random.split(k_attack, n_leaves), leaves)]
    noi = [np.asarray(jax.random.normal(k, x.shape, x.dtype))
           for k, x in zip(jtransport._leaf_keys(k_noise, n_leaves), leaves)]
    return (jax.tree_util.tree_unflatten(treedef, att),
            jax.tree_util.tree_unflatten(treedef, noi))


WIRE = [
    dict(method="mean"),
    dict(method="median"),
    dict(method="trimmed", trim_beta=0.25),
    dict(method="dcq"),
    dict(method="mean", dp_sigma=0.05),
    dict(method="dcq", dp_eps=2.0, dp_n=50),
    dict(method="median", attack="scale"),
    dict(method="dcq", attack="signflip", dp_sigma=0.01),
    dict(method="trimmed", attack="gauss", attack_factor=3.0),
    dict(method="dcq", attack="adaptive_scale", dp_eps=1.0, dp_n=20),
]


@pytest.mark.parametrize("kw", WIRE, ids=lambda kw: "-".join(
    f"{v}" for v in kw.values()))
def test_robust_aggregate_matches_reference(ref_grads, kw, monkeypatch):
    """The DCQ forms count machine values below med + scale * Delta_k; the
    two packages' float32 knots Delta_k differ by up to 2 ulp (ROADMAP C),
    so at m = 4 a value within an ulp of a threshold can flip its count
    and move that coordinate. Given the reference's knots, every
    coordinate agrees within 2e-5; with its own, at least 99.99% do. The
    error is relative to the leaf's scale: the noise makes the inputs
    ~1e2-1e3 while a coordinate's aggregate may lie near 0. The tree is
    a cut of the gradient tree (a matrix, a stacked matrix, a stacked
    vector and a vector), which keeps the reference's eager run short."""
    g = ref_grads[1]
    grads = {"embed": g["embed"], "norm_f": g["norm_f"],
             "layers": {"attn": {"w_k": g["layers"]["attn"]["w_k"]},
                        "norm1": g["layers"]["norm1"]}}
    cfg = jga.GradAggConfig(**kw)
    tcfg = tga.GradAggConfig(**kw)
    mask = np.arange(M) < 1
    key = jax.random.PRNGKey(11)
    att, noi = _wire_draws(grads, key, len(jax.tree_util.tree_leaves(grads)))
    want = jax.jit(lambda g, k, m: jga.robust_aggregate(g, cfg, k, m))(
        grads, key, jnp.asarray(mask))

    def port():
        return _tleaves_np(tga.robust_aggregate(
            tree_from_numpy(grads, "cpu"), tcfg, None,
            torch.from_numpy(mask), noise=tree_from_numpy(noi, "cpu"),
            attack_noise=tree_from_numpy(att, "cpu")))
    got = port()
    exact = kw["method"] == "median" and "dp_sigma" not in kw
    close = total = 0
    for a, b in zip(got, _leaves_np(want)):
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(a, b)
        close += int(np.isclose(a, b, atol=2e-5 * max(1.0, np.abs(b).max()),
                                rtol=2e-5).sum())
        total += a.size
    assert close >= 0.9999 * total, f"{total - close} of {total} apart"
    if kw["method"] == "dcq":
        from repro.agg import reference as jref
        from repro_torch.agg import reference as tref
        knots = np.asarray(jref.quantile_knots(10))
        monkeypatch.setattr(tref, "quantile_knots", lambda K, device=None:
                            torch.tensor(knots, device=device))
        got = port()
    for a, b in zip(got, _leaves_np(want)):
        np.testing.assert_allclose(a, b, rtol=2e-5,
                                   atol=2e-5 * max(1.0, np.abs(b).max()))


def test_calibration_and_spend_record_bit_equal(ref_grads):
    grads = ref_grads[1]
    tg = tree_from_numpy(grads, "cpu")
    for kw in (dict(dp_eps=1.0, dp_n=2), dict(dp_eps=0.3, dp_n=64,
                                              dp_tail="subgauss"),
               dict(dp_sigma=0.1), dict()):
        jc, tc = jga.GradAggConfig(**kw), tga.GradAggConfig(**kw)
        if "dp_eps" in kw:
            assert transport.tree_leaves(tga.calibrate_leaf_sigmas(tg, tc)) \
                == jax.tree_util.tree_leaves(jga.calibrate_leaf_sigmas(
                    grads, jc))
        for axis in (True, False):
            assert tga.spend_record(tg, tc, machine_axis=axis) == \
                jga.spend_record(grads, jc, machine_axis=axis)
    with pytest.raises(ValueError, match="dp_n"):
        tga.calibrate_leaf_sigmas(tg, tga.GradAggConfig(dp_eps=1.0))


def test_wire_edges():
    t = {"w": torch.ones(3, 2)}
    assert tga.add_dp_noise(t, 0.0, None) is t           # exact no-op
    assert tga.corrupt_machines(t, None, tga.GradAggConfig(
        attack="scale")) is t
    # round-aware attacks default to the terminal round, as the reference's
    vals = np.arange(12, dtype=np.float32).reshape(4, 3)
    mask = np.array([True, False, False, False])
    cfg = dict(attack="adaptive_scale", attack_factor=-3.0)
    got = tga.corrupt_machines([torch.from_numpy(vals)],
                               torch.from_numpy(mask),
                               tga.GradAggConfig(**cfg))[0]
    want = jga.corrupt_machines([jnp.asarray(vals)], jnp.asarray(mask),
                                jga.GradAggConfig(**cfg),
                                jax.random.PRNGKey(0))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the result keeps the gradient's dtype
    b16 = torch.randn(4, 5).to(torch.bfloat16)
    out = tga.aggregate_machine_axis(b16, tga.GradAggConfig(method="dcq"))
    assert out.dtype == torch.bfloat16 and out.shape == (5,)
    with pytest.raises(ValueError, match="unknown aggregation"):
        tga.aggregate_machine_axis(b16, tga.GradAggConfig(method="nope"))
    # the sharded strategy and a mesh aggregate through the gather, at
    # world 1 here (the ranks are in tests/test_torch_dist_ranks.py)
    from repro_torch.dist.collectives import tree_machine_specs
    from repro_torch.launch.cli import sharded_run
    u = {"w": torch.from_numpy(vals)}
    sharded = tga.GradAggConfig(strategy="sharded")
    want = tga.robust_aggregate(u, tga.GradAggConfig())["w"]
    with sharded_run(4, "cpu", True) as mesh:
        got = tga.robust_aggregate(
            u, sharded, mesh=mesh,
            machine_specs=tree_machine_specs(u, mesh))["w"]
        tx = tga.transmit_tree(u, tga.GradAggConfig(), mesh=mesh)["w"]
    assert torch.equal(got, want) and torch.equal(tx, want)
    # transmit_tree forwards its round to round-aware attacks
    got = tga.transmit_tree({"w": torch.from_numpy(vals)},
                            tga.GradAggConfig(method="mean", **cfg),
                            byz_mask=torch.from_numpy(mask), round_idx=1)
    want = jga.transmit_tree({"w": jnp.asarray(vals)},
                             jga.GradAggConfig(method="mean",
                                               use_pallas=False, **cfg),
                             jax.random.PRNGKey(0), jnp.asarray(mask),
                             round_idx=1)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)


# -------------------------------------------------------------- optimizers

def _opt_inputs(seed=3):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((6, 5)).astype(np.float32),
              "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda x: (s * rng.standard_normal(x.shape)).astype(np.float32),
        params) for s in (0.3, 2.0, 0.01)]
    return params, grads


@pytest.mark.parametrize("name,kw", [
    ("AdamW", dict(lr=1e-2)), ("AdamW", dict(lr=1e-2, weight_decay=0.1)),
    ("AdamW", dict(lr=3e-3, grad_clip=0.0)), ("SGD", dict(lr=0.1)),
    ("SGD", dict(lr=0.05, momentum=0.0))])
def test_optimizers_match_reference(name, kw):
    params, grads = _opt_inputs()
    jo, to = getattr(jopt, name)(**kw), getattr(topt, name)(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_from_numpy(params, "cpu")
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tree_from_numpy(g, "cpu"), ts, tp)
        tp = topt.apply_updates(tp, tu)
        for a, b in zip(_tleaves_np(tp), _leaves_np(jp)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert ts.step == int(js.step) == 3
    for a, b in zip(_tleaves_np(ts[1:]), _leaves_np(js[1:])):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(
        topt.global_norm(tree_from_numpy(grads[1], "cpu")).item(),
        float(jopt.global_norm(grads[1])), rtol=1e-6)


def test_adamw_bf16_update_is_cast_before_the_add():
    """A bf16 parameter gets the f32 update rounded to bf16 and then the
    bf16 add, as the reference's ``p + u.astype(p.dtype)``."""
    params, grads = _opt_inputs(4)
    jp = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                params)
    tp = transport.tree_map(lambda x: x.to(torch.bfloat16),
                            tree_from_numpy(params, "cpu"))
    jo, to = jopt.AdamW(lr=0.05), topt.AdamW(lr=0.05)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jg = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
        tg = transport.tree_map(lambda x: x.to(torch.bfloat16),
                                tree_from_numpy(g, "cpu"))
        ju, js = jo.update(jg, js, jp)
        jp = jopt.apply_updates(jp, ju)
        tu, ts = to.update(tg, ts, tp)
        tp = topt.apply_updates(tp, tu)
    for a, b in zip(_tleaves_np(tp), _leaves_np(jp)):
        np.testing.assert_allclose(a, b, rtol=2.0 ** -8, atol=1e-6)


# ----------------------------------------------------------------- trainer

@pytest.fixture(scope="module")
def ref_run(ref):
    """Three steps of the reference's Trainer (dcq, dp_eps = 1, 25%
    signflip) and its draws, tokens and final state."""
    cfg, jm, jparams, _ = ref
    agg = dict(method="dcq", dp_eps=1.0, dp_n=2, attack="signflip")
    # the reference aggregates through its plain version (use_pallas=False)
    tcfg = jtrainer.TrainConfig(n_machines=M, agg=jga.GradAggConfig(
        **agg, use_pallas=False))
    opt = jopt.AdamW(lr=3e-4)
    rng = np.random.default_rng(5)
    batches = [_np_batch(rng, 8, 32, cfg.vocab) for _ in range(3)]
    mask = jnp.arange(M) < 1
    key = jax.random.PRNGKey(6)
    trainer = jtrainer.Trainer(jm, opt, tcfg)
    metrics = []
    params, state, _ = trainer.fit(
        jparams, iter(batches), key, byz_mask=mask,
        callback=lambda i, m: metrics.append(
            (float(m["loss"]), float(m["grad_norm"]))))
    # the noise of step i: Trainer.fit splits the key once per step, and
    # robust_aggregate draws leaf by leaf from the second half of a split
    leaves, treedef = jax.tree_util.tree_flatten(jparams)

    @jax.jit
    def step_noise(sub):
        k_noise = jax.random.split(sub)[1]
        return jax.tree_util.tree_unflatten(treedef, [
            jax.random.normal(kk, (M,) + x.shape, x.dtype) for kk, x in
            zip(jtransport._leaf_keys(k_noise, len(leaves)), leaves)])
    noise, k = [], key
    for _ in batches:
        k, sub = jax.random.split(k)
        noise.append(_np(step_noise(sub)))
    return dict(agg=agg, batches=[_np(b) for b in batches], noise=noise,
                metrics=metrics, params=_np(params), state=_np(state),
                ledger=trainer.ledger)


def test_trainer_matches_reference_over_three_steps(ref, ref_run):
    model, _ = _port(ref)
    tcfg = ttrainer.TrainConfig(n_machines=M,
                                agg=tga.GradAggConfig(**ref_run["agg"]))
    trainer = ttrainer.Trainer(model, topt.AdamW(lr=3e-4), tcfg)
    metrics = []
    params, state, hist = trainer.fit(
        model.params(), [batch_from_numpy(b, "cpu")
                         for b in ref_run["batches"]],
        byz_mask=torch.arange(M) < 1,
        noise=[tree_from_numpy(z, "cpu") for z in ref_run["noise"]],
        callback=lambda i, m: metrics.append(
            (m["loss"].item(), m["grad_norm"].item())))
    assert hist[0]["step"] == 0 and len(metrics) == 3
    want = np.array(ref_run["metrics"])
    np.testing.assert_allclose(np.array(metrics), want, rtol=1e-4)
    lr, steps = 3e-4, 3
    got, ref_p = _tleaves_np(params), _leaves_np(ref_run["params"])
    close = sum(int(np.isclose(a, b, atol=1e-5, rtol=0).sum())
                for a, b in zip(got, ref_p))
    total = sum(a.size for a in got)
    assert close >= 0.9999 * total, f"{total - close} of {total} apart"
    for a, b in zip(got, ref_p):
        assert np.abs(a - b).max() <= 2 * lr * steps
    assert state.step == 3
    assert trainer.ledger == ref_run["ledger"]
    assert len(trainer.ledger["per_step"]) == 12
    assert [r["dim"] for r in trainer.ledger["per_step"]] == [
        int(np.prod(x.shape)) for x in transport.tree_leaves(params)]


def test_opt_state_from_reference(ref_run):
    st = opt_state_from_reference(ref_run["state"], device="cpu")
    assert st.step == 3
    for a, b in zip(_tleaves_np(st.mu), _leaves_np(ref_run["state"].mu)):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------------- LM data

def test_markov_chain_matches_the_reference_scan():
    key = jax.random.PRNGKey(9)
    B, S, V = 3, 200, 512
    want = np.asarray(jlm.markov_tokens(key, B, S, V))
    k1, k2, k3 = jax.random.split(key, 3)
    first = np.asarray(jax.random.randint(k1, (B, 1), 0, V))
    flips = np.asarray(jax.random.bernoulli(k2, 0.8, (B, S - 1)))
    rand = np.asarray(jax.random.randint(k3, (B, S - 1), 0, V))
    got = tlm.markov_chain(*(torch.from_numpy(np.array(a)) for a in
                             (first, flips, rand)), V)
    np.testing.assert_array_equal(got.numpy(), want)
    # and at the full vocab, where a*x + c and a^k x would overflow int32
    V = 151552
    rand = np.random.default_rng(0).integers(0, V, (B, S - 1))
    first = rand[:, :1]
    got = tlm.markov_chain(*(torch.from_numpy(np.array(a)) for a in
                             (first, flips, rand)), V)
    x = first[:, 0].astype(np.int64)
    for t in range(S - 1):
        x = np.where(flips[:, t], (31 * x + 17) % V, rand[:, t])
        assert np.array_equal(got[:, t + 1].numpy(), x)


def test_lm_batches():
    cfg = get_config(ARCH, reduced=True)
    g = torch.Generator().manual_seed(0)
    batches = list(tlm.synthetic_lm_batches(g, cfg, 3, 4, 16))
    assert len(batches) == 3
    b = batches[0]
    assert b["tokens"].shape == b["labels"].shape == (4, 16)
    assert b["tokens"].dtype == torch.int64
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert int(b["tokens"].max()) < cfg.vocab
    # the ssm, moe and hybrid families take the same batches; the audio
    # family's tokens are the chain over its codebooks, the vlm's batch
    # adds its f32 patch embeddings (tests/test_torch_archs.py)
    for arch in ("xlstm-125m", "qwen3-moe-30b-a3b", "zamba2-7b",
                 "musicgen-medium", "llava-next-mistral-7b"):
        other = get_config(arch, reduced=True)
        b = tlm.make_batch(torch.Generator().manual_seed(0), other, 4, 16)
        toks = b["tokens"] if other.family != "audio" else \
            b["tokens"][..., 0]
        assert toks.shape == b["labels"].shape == (4, 16)
        assert torch.equal(toks[:, 1:], b["labels"][:, :-1])
        assert int(b["tokens"].max()) < other.vocab
        assert ("patch_embeds" in b) == (other.family == "vlm")
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-x")


# ---------------------------------------------------------- checkpoints

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways(ref, tmp_path, dtype):
    """The same tree and AdamW state saved by each package: the files hold
    the same keys, dtypes and bytes, and each package restores the
    other's. (The reference's restore cannot cast its own bf16 ``|V2``
    leaves back, so in bf16 the reference's side is checked by bytes.)"""
    cfg, jm, jparams, _ = ref
    jdt = getattr(jnp, dtype)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jdt), jparams)
    jo = jopt.AdamW()
    js = jo.init(jp)
    js = js._replace(step=jnp.asarray(4, jnp.int32),
                     mu=jax.tree_util.tree_map(lambda x: x + 0.5, js.mu))
    tp = transport.tree_map(lambda x: x.to(getattr(torch, dtype)),
                            tree_from_numpy(_np(jp), "cpu"))
    ts = opt_state_from_reference(_np(js), "cpu")
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(jpath, jp, js, step=9, meta={"arch": ARCH})
    tckpt.save(tpath, tp, ts, step=9, meta={"arch": ARCH})
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "opt/.step" in a.files and "params/layers/attn/w_q" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k
    # the port restores the reference's file
    like = transport.tree_map(torch.zeros_like, tp)
    p2, s2, step, meta = tckpt.restore(jpath, like, topt.AdamW().init(like))
    assert step == 9 and meta == {"arch": ARCH} and s2.step == 4
    for a, b in zip(transport.tree_leaves(p2), transport.tree_leaves(tp)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(transport.tree_leaves(s2.mu), transport.tree_leaves(ts.mu)):
        assert torch.equal(a, b)
    if dtype == "float32":
        # the reference restores the port's file
        q, o, step, _ = jckpt.restore(tpath, jp, js)
        assert step == 9 and int(o.step) == 4
        for a, b in zip(jax.tree_util.tree_leaves(q),
                        jax.tree_util.tree_leaves(jp)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    bad = transport.tree_map(lambda x: torch.zeros(x.shape + (1,)), tp)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(tpath, bad)


