"""Shared checks of a reduced model-zoo family of repro_torch against the
JAX reference on the CPU, used by tests/test_torch_xlstm.py,
test_torch_moe.py and test_torch_hybrid.py (one file per family, so that
pytest-xdist's ``--dist loadfile`` spreads them).

:func:`reference_run` computes the reference's side once per module from
its own ``Model.init`` parameters and numpy tokens of a seed: forward
logits and loss, ``jax.grad`` of the loss, 24 decode steps, 12 decode
steps of the same config in bf16, and two quasi-Newton steps of its
``protocol_tree_rounds`` (machine 0 signflipped, each step from the
state the step before reached). The ``check_*`` functions run the port
on the same inputs and hold it at the tolerances stated there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.configs.base import TreeProtocolConfig as JTreeCfg
from repro.core.bfgs import LBFGSMemory as JLBFGSMemory
from repro.core.protocol import protocol_tree_rounds as jrounds
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.configs.base import TreeProtocolConfig
from repro_torch.core import transport
from repro_torch.core.protocol import protocol_tree_rounds
from repro_torch.interop import (batch_from_numpy, cache_from_reference,
                                 lbfgs_memory_from_reference,
                                 params_from_reference, tree_from_numpy,
                                 tree_to_numpy)
from repro_torch.models.model import Model as TModel
from repro_torch.train import trainer as ttrainer

#: f32 forward, loss and decode (sums over d_model = 256 in another order)
ATOL = RTOL = 1e-4
#: the reference's own prefill-against-decode tolerance
#: (tests/test_models.py::test_prefill_equals_decode)
PREFILL_ATOL, PREFILL_RTOL = 5e-4, 1e-3
#: bf16 logits of size ~1: a few bf16 ulps (as test_torch_models.py's
#: dense bf16 decode)
BF16_TOL = 2.0 ** -5
B, S, STEPS, BF16_STEPS = 2, 24, 24, 12
#: the QN steps: machines, batch rows x tokens, steps
M, QN_BATCH, QN_SEQ, QN_STEPS = 4, 8, 16, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16(cfg):
    return dataclasses.replace(cfg, dtype="bfloat16")


def _decode(jm, params, cfg, toks, steps):
    cache = jm.init_cache(B, steps)
    step = jax.jit(jm.decode_step)
    out = []
    for t in range(steps):
        lg, cache = step(params, cache, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        out.append(np.asarray(lg, np.float32))
    return np.concatenate(out, axis=1)


def reference_run(arch: str, seed: int = 0) -> dict:
    """The reference's results for the reduced ``arch`` (see the module
    docstring), as numpy."""
    cfg = jget_config(arch, reduced=True)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, aux = jax.jit(jm.forward)(params, jb)
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(params, jb)
    decode = _decode(jm, params, cfg, batch["tokens"], STEPS)
    # bf16: the same parameters rounded to bf16
    jm16 = JModel(_bf16(cfg))
    p16 = jax.tree_util.tree_map(
        lambda a, b: a.astype(b.dtype), params,
        jax.eval_shape(jm16.init, jax.random.PRNGKey(0)))
    decode16 = _decode(jm16, p16, _bf16(cfg), batch["tokens"], BF16_STEPS)
    return {"arch": arch, "cfg": get_config(arch, reduced=True),
            "params": _np(params), "params16": _np(p16), "batch": batch,
            "logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "ce": float(parts["ce"]),
            "grads": _np(grads), "decode": decode, "decode16": decode16}


def reference_qn_run(arch: str, agg: str, seed: int = 0) -> dict:
    """QN_STEPS noiseless steps of the reference's engine on its own
    parameters, ``aggregator=agg``, machine 0 signflipped, each from the
    state the one before reached: per step the tokens, the starting
    parameters and memory, and the result, as numpy."""
    cfg = jget_config(arch, reduced=True)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tcfg = JTreeCfg(aggregator=agg)
    mem = JLBFGSMemory.init_like(tcfg.hist, params, machines=M)
    mask = jnp.arange(M) < 1

    def grad_fn(p, b):
        (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(p, b)
        return loss, g

    @jax.jit
    def engine(p, mm, batch):
        # noiseless and signflip: the key draws nothing
        mb = jax.tree_util.tree_map(
            lambda x: x.reshape((M, x.shape[0] // M) + x.shape[1:]), batch)
        return jrounds(jax.random.PRNGKey(0), p, mb, grad_fn, tcfg, mem=mm,
                       byz_mask=mask, attack="signflip")
    rng = np.random.default_rng(100 + seed)
    steps = []
    for _ in range(QN_STEPS):
        toks = rng.integers(0, cfg.vocab, (QN_BATCH, QN_SEQ + 1)) \
            .astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        out = engine(params, mem, {k: jnp.asarray(v) for k, v in
                                   batch.items()})
        steps.append({"batch": batch, "params": _np(params),
                      "mem": _np(mem), "out": _np(out)})
        params, mem = out.theta_qn, out.mem
    return {"agg": agg, "steps": steps}


# ------------------------------------------------------------------ checks

def port_model(ref, bf16=False):
    cfg = _bf16(ref["cfg"]) if bf16 else ref["cfg"]
    return params_from_reference(ref["params16" if bf16 else "params"], cfg,
                                 device="cpu")


def _tokens(a):
    return torch.from_numpy(np.array(a)).long()


def check_forward_and_loss(ref):
    """Logits, the aux loss, the cross entropy and the loss at atol = rtol
    = 1e-4."""
    model = port_model(ref)
    batch = batch_from_numpy(ref["batch"], "cpu")
    with torch.no_grad():
        logits, aux = model.forward(batch)
        loss, parts = model.loss(batch)
    np.testing.assert_allclose(logits.numpy(), ref["logits"], atol=ATOL,
                               rtol=RTOL)
    for got, want in ((aux, ref["aux"]), (parts["ce"], ref["ce"]),
                      (loss, ref["loss"])):
        np.testing.assert_allclose(got.item(), want, atol=ATOL, rtol=RTOL)


def check_gradients(ref, remat: bool):
    """``torch.autograd`` of the loss against ``jax.grad``, leaf for leaf,
    within 1e-4 of each leaf's largest magnitude (remat changes memory,
    not numbers)."""
    model = port_model(ref)
    model.remat = remat
    loss, _ = model.loss(batch_from_numpy(ref["batch"], "cpu"))
    loss.backward()
    paths = transport.leaf_paths(model.params())
    want = transport.tree_leaves(ref["grads"])
    assert len(paths) == len(want)
    for path, p, g in zip(paths, transport.tree_leaves(model.params()),
                          want):
        scale = max(float(np.abs(g).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - g).max()) / scale
        assert err <= 1e-4, (path, err)


def check_prefill_and_decode(ref):
    """STEPS decode steps from an empty cache: against the reference's
    decode at atol = rtol = 1e-4, and against the reference's prefill
    logits and the port's own at the reference's 5e-4 / 1e-3."""
    model = port_model(ref)
    toks = ref["batch"]["tokens"]
    cache = model.init_cache(B, STEPS)
    out = []
    for t in range(STEPS):
        lg, cache = model.decode_step(cache, {"tokens": _tokens(toks[:, t:t + 1])})
        out.append(lg.numpy())
    dec = np.concatenate(out, axis=1)
    assert cache["pos"] == STEPS
    np.testing.assert_allclose(dec, ref["decode"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(dec, ref["logits"], atol=PREFILL_ATOL,
                               rtol=PREFILL_RTOL)
    with torch.no_grad():
        full, _ = model.forward({"tokens": _tokens(toks)})
    np.testing.assert_allclose(dec, full.numpy(), atol=PREFILL_ATOL,
                               rtol=PREFILL_RTOL)


def check_bf16_decode(ref):
    """The config in bf16 on both sides, the same parameters rounded to
    bf16, BF16_STEPS steps: logits within 2^-5 and the same greedy tokens.
    Two logits that lie within the tolerance of each other can swap, so
    the greedy token is held wherever the reference's top two logits are
    more than twice the tolerance apart (the reduced moe's are within it
    at most positions, and tie exactly at some)."""
    model = port_model(ref, bf16=True)
    toks = ref["batch"]["tokens"]
    cache = model.init_cache(B, BF16_STEPS)
    held = 0
    for t in range(BF16_STEPS):
        lg, cache = model.decode_step(cache, {"tokens": _tokens(toks[:, t:t + 1])})
        assert lg.dtype == torch.bfloat16
        got, want = lg.float().numpy()[:, 0], ref["decode16"][:, t]
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL,
                                   err_msg=f"step {t}")
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16_TOL * (
            1 + np.abs(top2[:, 1]))
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
        held += int(clear.sum())
    assert held > 0


def _state(cache):
    return {k: v for k, v in cache.items() if k != "pos"}


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def check_interop(ref, f32_leaves):
    """``params_from_reference`` keeps the reference's leaf paths, order
    and per-leaf dtypes, and ``Model.params()`` of a model the port draws
    itself has the same: in a bf16 model the leaves named in
    ``f32_leaves`` stay f32 and every other leaf is bf16. The decode
    cache crosses with its layout and dtypes (the recurrent states f32),
    and the port's own ``init_cache`` has the same."""
    cfg16 = _bf16(ref["cfg"])
    jm16 = JModel(_bf16(jget_config(ref["arch"], reduced=True)))
    jtree = jm16.init(jax.random.PRNGKey(1))
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in
             jax.tree_util.tree_leaves_with_path(jtree)]
    dtypes = [str(x.dtype) for x in jax.tree_util.tree_leaves(jtree)]
    assert dtypes == ["float32" if p.split("/")[-1] in f32_leaves
                      else "bfloat16" for p in paths]
    carried = params_from_reference(_np(jtree), cfg16, device="cpu")
    for model in (carried, TModel(cfg16, device="cpu")):
        tree = model.params()
        assert transport.leaf_paths(tree) == paths
        assert [_dtype(x) for x in transport.tree_leaves(tree)] == dtypes
    for a, b in zip(transport.tree_leaves(carried.params()),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a.detach().float().numpy(),
                                      np.asarray(b, np.float32))
    jcache = jm16.init_cache(B, 8)
    tcache = _state(cache_from_reference(_np(jcache), device="cpu"))
    jcache = _state(jcache)
    mine = _state(carried.init_cache(B, 8))
    assert transport.leaf_paths(tcache) == transport.leaf_paths(mine) \
        == transport.leaf_paths(jcache)
    for a, b, c in zip(transport.tree_leaves(tcache),
                       transport.tree_leaves(mine),
                       jax.tree_util.tree_leaves(jcache)):
        assert a.shape == b.shape == c.shape
        assert _dtype(a) == _dtype(b) == str(c.dtype)


def _close(got, want, share: float, atol=1e-4, tree_scale=False):
    """At least ``share`` of the coordinates within ``atol`` and rtol 1e-4;
    with ``tree_scale`` the atol is ``atol`` x the tree's largest
    magnitude."""
    paths = transport.leaf_paths(want)
    got = transport.tree_leaves(tree_to_numpy(got))
    want = [np.asarray(w, np.float32) for w in transport.tree_leaves(want)]
    assert len(got) == len(want)
    if tree_scale:
        atol *= max(float(np.abs(b).max()) for b in want)
    close = total = 0
    for a, b in zip(got, want):
        assert a.shape == b.shape
        close += int(np.isclose(a, b, atol=atol, rtol=1e-4).sum())
        total += a.size
    worst = max(zip((float(np.abs(a - b).max()) for a, b in zip(got, want)),
                    paths))
    assert close >= share * total, \
        f"{total - close} of {total} apart (atol {atol}); largest {worst}"


def _raw_y(grad_fn, theta_os, theta_cq, mb, machines):
    """Each of ``machines``' raw gradient difference g_j(theta_os) -
    g_j(theta_cq), leaf by leaf (R4's y before the wire)."""
    rows = []
    for j in machines:
        b = transport.tree_map(lambda x, j=j: x[j], mb)
        _, g1 = grad_fn(theta_os, b)
        _, g0 = grad_fn(theta_cq, b)
        rows.append([a - c for a, c in zip(transport.tree_leaves(g1),
                                           transport.tree_leaves(g0))])
    return rows


def check_qn_steps(ref, qn):
    """The port's engine from the reference's state at each step. The
    median holds theta_cq, theta_os, theta_qn and the memory's s within
    atol = rtol = 1e-4 on every coordinate, and the memory's y (each
    machine's raw gradient difference g_j(theta_os) - g_j(theta_cq), up to
    ~1.5) within rtol 1e-4 and an atol of 1e-4 x its largest magnitude on
    every coordinate. A second witness holds the gradient code alone: the
    port's y taken at the reference's own theta_os and theta_cq equals the
    reference's y of every machine that pushed, at the same tolerance, for
    either aggregator. dcq_mad (DCQ at m = 4 flips a coordinate where the
    two packages' f32 sums put a machine value on either side of a
    threshold, ROADMAP C) holds theta_cq and theta_os on 99.99% of the
    coordinates at every step, and theta_qn and the memory on 99.99% at the
    first step (an empty memory) and 99.9% later. Losses within rtol 1e-5,
    counts equal."""
    exact = qn["agg"] == "median"
    model = port_model(ref)
    grad_fn = ttrainer.make_grad_fn(model)
    tcfg = TreeProtocolConfig(aggregator=qn["agg"])
    mask = torch.arange(M) < 1
    for i, step in enumerate(qn["steps"]):
        theta = tree_from_numpy(step["params"], "cpu")
        mem = lbfgs_memory_from_reference(step["mem"], "cpu")
        mb = ttrainer.split_machines(batch_from_numpy(step["batch"], "cpu"),
                                     M)
        out = protocol_tree_rounds(None, theta, mb, grad_fn, tcfg, mem=mem,
                                   byz_mask=mask, attack="signflip")
        want = step["out"]
        np.testing.assert_allclose(out.losses.numpy(), want.losses,
                                   rtol=1e-5)
        np.testing.assert_array_equal(out.mem.count.numpy(),
                                      want.mem.count)
        first = 1.0 if exact else 0.9999
        later = 1.0 if exact else (0.9999 if i == 0 else 0.999)
        _close(out.theta_cq, want.theta_cq, first)
        _close(out.theta_os, want.theta_os, first)
        _close(out.theta_qn, want.theta_qn, later)
        _close(out.mem.s_hist, want.mem.s_hist, later)
        _close(out.mem.y_hist, want.mem.y_hist, later, tree_scale=True)
        pushed = np.flatnonzero(np.asarray(want.mem.count)
                                > np.asarray(step["mem"].count))
        assert pushed.size
        same = _raw_y(grad_fn, tree_from_numpy(want.theta_os, "cpu"),
                      tree_from_numpy(want.theta_cq, "cpu"), mb, pushed)
        _close([x for row in same for x in row],
               [np.asarray(h)[j, -1] for j in pushed
                for h in transport.tree_leaves(want.mem.y_hist)],
               1.0, tree_scale=True)
