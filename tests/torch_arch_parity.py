"""The reference's side of tests/test_torch_archs*.py: every architecture of
the catalogue at its reduced size (f32), its own ``Model.init``
parameters, a batch of its own ``data.lm.make_batch`` (the audio family's
(B, S, n_codebooks) tokens, the vlm's f32 ``patch_embeds``), and what the
reference computes from them, as numpy. Each result is computed once per
process (``functools.lru_cache``) and handed to the port through
``repro_torch.interop``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.data import lm as jlm
from repro.dist import grad_agg as jga
from repro.models.model import Model as JModel
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config
from repro_torch.interop import batch_from_numpy, params_from_reference

#: batch rows and tokens; decode steps
B, S, STEPS = 4, 16, 8
#: the AdamW step: machines (one row each), learning rate
M, LR = 4, 1e-3
#: f32 forward, loss and decode (sums over d_model <= 512 in another order)
ATOL = RTOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def reference_inputs(arch: str) -> dict:
    """The reduced ``arch``: its config, its own parameters and a batch of
    its ``make_batch``, as numpy."""
    cfg = jget_config(arch, reduced=True)
    params = JModel(cfg).init(jax.random.PRNGKey(0))
    batch = jlm.make_batch(jax.random.PRNGKey(1), cfg, B, S)
    return {"arch": arch, "cfg": get_config(arch, reduced=True),
            "params": _np(params), "batch": _np(batch)}


def _on_device(ref):
    jm = JModel(jget_config(ref["arch"], reduced=True))
    return (jm, jax.tree_util.tree_map(jnp.asarray, ref["params"]),
            jax.tree_util.tree_map(jnp.asarray, ref["batch"]))


@functools.lru_cache(maxsize=None)
def reference_forward(arch: str) -> dict:
    """The logits and aux loss, the loss and its cross entropy."""
    jm, params, batch = _on_device(reference_inputs(arch))
    (logits, aux), (loss, parts) = jax.jit(
        lambda p, b: (jm.forward(p, b), jm.loss(p, b)))(params, batch)
    return {"logits": np.asarray(logits), "aux": float(aux),
            "loss": float(loss), "ce": float(parts["ce"])}


@functools.lru_cache(maxsize=None)
def reference_grads(arch: str) -> dict:
    """``jax.grad`` of the loss, as numpy."""
    jm, params, batch = _on_device(reference_inputs(arch))
    return _np(jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(params,
                                                                 batch))


@functools.lru_cache(maxsize=None)
def reference_decode(arch: str) -> np.ndarray:
    """STEPS decode steps from an empty cache on the batch's first STEPS
    tokens ((B, 1, nc) a step for audio): the logits (B, STEPS, V)."""
    ref = reference_inputs(arch)
    jm, params, _ = _on_device(ref)
    cache = jm.init_cache(B, STEPS)
    step = jax.jit(jm.decode_step)
    toks = ref["batch"]["tokens"]
    out = []
    for t in range(STEPS):
        lg, cache = step(params, cache,
                         {"tokens": jnp.asarray(toks[:, t:t + 1])})
        out.append(np.asarray(lg, np.float32))
    return np.concatenate(out, axis=1)


@functools.lru_cache(maxsize=None)
def reference_train_step(arch: str) -> dict:
    """One step of the reference's ``Trainer`` (AdamW, lr LR, M machines
    of one row each, the median, machine 0 signflipped, no noise: the
    wire draws nothing) through its plain aggregation
    (``use_pallas=False``): the loss, the grad norm and the parameters
    after the step."""
    ref = reference_inputs(arch)
    jm, params, batch = _on_device(ref)
    tcfg = jtrainer.TrainConfig(n_machines=M, agg=jga.GradAggConfig(
        method="median", attack="signflip", use_pallas=False))
    trainer = jtrainer.Trainer(jm, jopt.AdamW(lr=LR), tcfg)
    metrics = []
    params, _, _ = trainer.fit(
        params, iter([batch]), jax.random.PRNGKey(3),
        byz_mask=jnp.arange(M) < 1,
        callback=lambda i, m: metrics.append(
            (float(m["loss"]), float(m["grad_norm"]))))
    return {"metrics": metrics, "params": _np(params)}


def port_model(ref):
    """The port's model holding the reference's parameters, on the CPU."""
    return params_from_reference(ref["params"], ref["cfg"], device="cpu")


def port_batch(ref):
    return batch_from_numpy(ref["batch"], "cpu")


def tokens(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).long()
