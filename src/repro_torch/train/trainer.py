"""Training loop: per-machine gradients -> attack -> DP noise -> robust
aggregation -> optimizer update — ``repro/train/trainer.py`` counterpart,
the AdamW path.

The global batch is split into ``n_machines`` groups (the paper's node
machines). The reference takes one gradient per machine with
``jax.vmap``; here a loop over the machines runs ``torch.autograd.grad``
once each and writes every machine's gradient straight into one
``(m, *leaf)`` buffer per parameter leaf, in the parameters' dtype (as
``jax.grad`` gives it; with ``microbatch > 0`` the reference accumulates
into f32 zeros, and so does this, so the wire then carries f32).
``dist.grad_agg.robust_aggregate`` then applies the attack, the Gaussian
mechanism and the robust aggregator (one B1 launch per leaf on the card);
the aggregate feeds the optimizer, which updates the parameters in place.
With ``method="mean"``, no noise and no attack this is data-parallel
training.

Rematerialisation is the model's (``Model(remat=True)``, the reference's
``jax.checkpoint`` over the layer scan): live activations are then one
layer's, per machine. ``TrainConfig.remat`` is kept for the reference's
field list and, as there, read by nothing.

``fsdp`` and a ``mesh`` wait for the multi-device slice (ROADMAP A10);
``QNTrainConfig``/``make_qn_train_step``/``QNTrainer`` (the quasi-Newton
protocol as the train step) for ROADMAP A11.4.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch.core.transport import tree_flatten, tree_unflatten
from repro_torch.dist.grad_agg import (GradAggConfig, robust_aggregate,
                                       spend_record)
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, apply_updates, global_norm

__all__ = ["TrainConfig", "machine_grads", "make_train_step", "Trainer",
           "QNTrainConfig",
           "make_qn_train_step", "QNTrainer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_machines: int = 4
    microbatch: int = 0            # per-machine microbatch; 0 = whole batch
    remat: bool = True
    fsdp: bool = False             # weight sharding (ROADMAP A10)
    grad_dtype: str = ""           # "" = native; "bfloat16" halves the
    #                                aggregation payload
    agg: GradAggConfig = dataclasses.field(
        default_factory=lambda: GradAggConfig(method="mean"))


def _refuse(tcfg: TrainConfig, mesh) -> None:
    if tcfg.fsdp or mesh is not None:
        raise NotImplementedError(
            "fsdp and a device mesh are not ported yet: they wait for the "
            "multi-device slice (ROADMAP A10)")


def _split_machines(batch: Dict[str, torch.Tensor], m: int) -> list:
    """One sub-batch per machine: rows [i*B/m, (i+1)*B/m) of every entry."""
    B = next(iter(batch.values())).shape[0]
    if B % m:
        raise ValueError(f"global batch {B} does not split over {m} "
                         f"machines")
    return [{k: v[i * (B // m):(i + 1) * (B // m)] for k, v in batch.items()}
            for i in range(m)]


def _value_and_grad(model: Model, leaves, treedef, mb):
    p = tree_unflatten(treedef, leaves)
    with torch.enable_grad():
        loss, _ = model.loss(mb, params=p)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def _machine_grad(model: Model, leaves, treedef, mb, bufs, i: int,
                  microbatch: int) -> torch.Tensor:
    """Machine i's loss; its gradient goes into ``bufs[*][i]``."""
    if not microbatch:
        loss, grads = _value_and_grad(model, leaves, treedef, mb)
        for b, g in zip(bufs, grads):
            b[i].copy_(g)
        return loss
    B = next(iter(mb.values())).shape[0]
    k = max(1, B // microbatch)
    for b in bufs:
        b[i].zero_()
    lsum = torch.zeros((), dtype=torch.float32, device=bufs[0].device)
    for c in range(k):
        chunk = {n: v[c * (B // k):(c + 1) * (B // k)] for n, v in mb.items()}
        lv, grads = _value_and_grad(model, leaves, treedef, chunk)
        lsum = lsum + lv / k
        for b, g in zip(bufs, grads):
            b[i].add_(g / k)
    return lsum


def machine_grads(model: Model, params: Any, batch: Dict[str, torch.Tensor],
                  tcfg: TrainConfig):
    """``(losses (m,), grads)``: every machine's loss and the gradient tree
    of ``params``' shape with leaves ``(m, *leaf)``, in the parameters'
    dtype (f32 with microbatches; then cast to ``tcfg.grad_dtype`` where
    set) — the reference's ``jax.vmap(machine_grad)``."""
    m = tcfg.n_machines
    leaves, treedef = tree_flatten(params)
    leaves = [x if x.requires_grad else x.detach().requires_grad_()
              for x in leaves]
    bufs = [torch.empty((m,) + tuple(x.shape),
                        dtype=torch.float32 if tcfg.microbatch else x.dtype,
                        device=x.device) for x in leaves]
    losses = torch.stack([
        _machine_grad(model, leaves, treedef, mb, bufs, i, tcfg.microbatch)
        for i, mb in enumerate(_split_machines(batch, m))])
    if tcfg.grad_dtype:
        dt = _DTYPES[tcfg.grad_dtype]
        bufs = [b.to(dt) for b in bufs]
    return losses, tree_unflatten(treedef, bufs)


def make_train_step(model: Model, opt: AdamW, tcfg: TrainConfig,
                    mesh=None):
    """Returns ``train_step(params, opt_state, batch, key, byz_mask=None,
    *, noise=None, attack_noise=None, with_agg=False) -> (params,
    opt_state, metrics)``. ``params`` is a tree of ``Model.params()``'s
    shape (the module's own, or any tree of that shape) and is updated in
    place; ``key`` a ``torch.Generator`` for the wire's draws, which
    ``noise``/``attack_noise`` (trees of standard normals shaped like the
    per-machine gradients) replace. ``metrics``: ``loss`` (the machines'
    mean), ``loss_per_machine`` (m,), ``grad_norm`` of the aggregate, all
    device tensors, and with ``with_agg`` the aggregated gradient
    ``agg``."""
    _refuse(tcfg, mesh)

    def train_step(params, opt_state, batch, key=None, byz_mask=None, *,
                   noise=None, attack_noise=None, with_agg=False):
        losses, grads = machine_grads(model, params, batch, tcfg)
        agg = robust_aggregate(grads, tcfg.agg, key, byz_mask, noise=noise,
                               attack_noise=attack_noise)
        del grads               # the (m, *leaf) buffers, before AdamW's
        updates, opt_state = opt.update(agg, opt_state, params)
        params = apply_updates(params, updates)
        del updates
        metrics = {"loss": losses.mean(), "loss_per_machine": losses,
                   "grad_norm": global_norm(agg)}
        if with_agg:
            metrics["agg"] = agg
        return params, opt_state, metrics

    return train_step


class Trainer:
    """The loop: batches in, one robust-DP step each, a DP ledger out."""

    def __init__(self, model: Model, opt: AdamW, tcfg: TrainConfig,
                 mesh=None):
        self.model, self.opt, self.tcfg = model, opt, tcfg
        self.step_fn = make_train_step(model, opt, tcfg, mesh)
        self.ledger = None  # set by fit(): per-step DP spend records

    def fit(self, params: Any, batches: Iterable[Dict[str, torch.Tensor]],
            key: Optional[torch.Generator] = None, byz_mask=None,
            log_every: int = 10, callback=None, noise: Any = None):
        """Train on ``batches``; returns ``(params, opt_state, history)``
        with ``history`` the logged ``{step, loss}`` entries. ``key`` (a
        generator) feeds the wire's draws; ``noise`` (one tree of standard
        normals per step) replaces its Gaussian draws."""
        opt_state = self.opt.init(params)
        # every step transmits one noised gradient tree with a static noise
        # config, so one per-step ledger entry covers them all (basic
        # composition: total spend = steps x the per-step budget)
        per_step = spend_record(params, self.tcfg.agg, name="grad step")
        steps = 0
        history = []
        noise = iter(noise) if noise is not None else None
        for i, batch in enumerate(batches):
            params, opt_state, metrics = self.step_fn(
                params, opt_state, batch, key, byz_mask,
                noise=next(noise) if noise is not None else None)
            steps = i + 1
            if i % log_every == 0 or callback:
                history.append({"step": i, "loss": float(metrics["loss"])})
                if callback:
                    callback(i, metrics)
        eps = self.tcfg.agg.dp_eps
        self.ledger = {"per_step": per_step, "steps": steps,
                       "total_eps": steps * eps if eps > 0 else None}
        return params, opt_state, history


# ---------------------------------------------- quasi-Newton (protocol)

_QN = ("the quasi-Newton trainer (every step one run of Algorithm 1 over "
       "the parameter tree) is not ported yet: it waits for the pytree "
       "engine (ROADMAP A11.4)")


class QNTrainConfig:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_QN)


def make_qn_train_step(*args, **kwargs):
    raise NotImplementedError(_QN)


class QNTrainer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_QN)
