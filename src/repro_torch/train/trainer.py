"""Training loop: per-machine gradients -> attack -> DP noise -> robust
aggregation -> optimizer update — ``repro/train/trainer.py`` counterpart.

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

The quasi-Newton path (``QNTrainConfig``, ``make_qn_train_step``,
``QNTrainer``) makes every step one run of Algorithm 1's five
transmissions over the same parameter tree
(``core.protocol.protocol_tree_rounds``), with a per-machine L-BFGS memory
in place of the optimizer state.

A ``mesh`` spreads the machines over ``torch.distributed`` ranks: a
1-D machine mesh (``launch.cli.machine_mesh``) or a ``("data", "model")``
/ ``("pod", "data", "model")`` one (``launch.mesh.make_host_mesh``, the
reference's layout). Each rank computes its own machines' gradients
(``machine_grads``) or runs its own machines through the tree engine,
every leaf is gathered in machine order over the machine axis ("data" x
"pod") before the wire, and the aggregate and the update are the same on
every rank of the machine axis. A "model" axis shards the payload dims
(``dist.payload``): a rank holds the ``1 / model`` slice of every leaf
that ``models.sharding.param_spec`` puts on "model", and so of its AdamW
moments, of the machines' gradient rows and of the L-BFGS memory; the
step function's ``payload`` (None without a model axis) cuts a whole tree
into this rank's slices (``payload.shard``) and back
(``payload.unshard``). ``TrainConfig(fsdp=True)`` is a no-op on a mesh
without a "data" axis, as in the reference; with one it would put
"data", the machine axis, on a payload dim too, and is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch import obs
from repro_torch.configs.base import TreeProtocolConfig
from repro_torch.core.bfgs import LBFGSMemory
from repro_torch.core.protocol import (ALL_MACHINES, AllMachines,
                                       protocol_tree_rounds)
from repro_torch.core.transport import (active_payload, tree_flatten,
                                        tree_leaves, tree_unflatten)
from repro_torch.dist.grad_agg import (GradAggConfig, robust_aggregate,
                                       spend_record)
from repro_torch.dist.payload import maybe_active, payload_for
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, apply_updates, global_norm

__all__ = ["TrainConfig", "split_machines", "machine_grads",
           "make_loss_fn", "make_train_step", "Trainer",
           "QNTrainConfig", "make_grad_fn", "make_qn_train_step",
           "QNTrainer"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_machines: int = 4
    microbatch: int = 0            # per-machine microbatch; 0 = whole batch
    remat: bool = True
    fsdp: bool = False             # ZeRO-style weight sharding over "data":
    #                                a no-op without a "data" axis, refused
    #                                with one (it carries the machine axis)
    grad_dtype: str = ""           # "" = native; "bfloat16" halves the
    #                                aggregation payload
    agg: GradAggConfig = dataclasses.field(
        default_factory=lambda: GradAggConfig(method="mean"))


def _mesh_plan(mesh, model: Model, fsdp: bool = False):
    """``(machine map, payload)`` of ``mesh`` for ``model``: every machine
    here and no payload without a mesh; the machine axis over the mesh's
    machine axes; the payload over its "model" axis (None where it has
    none of more than one rank). Any other axis carries no rule, so the
    work is replicated over it, as GSPMD replicates over an axis no spec
    names. Refuses fsdp on a mesh whose "data" axis carries the machine
    axis."""
    if mesh is None:
        return ALL_MACHINES, None
    from repro_torch.dist.sharded_protocol import machine_map
    from repro_torch.models.sharding import mesh_shape
    axes = mesh_shape(mesh)
    if fsdp and "data" in axes:
        raise ValueError(
            "fsdp shards a payload dim over 'data', which carries the "
            "machine axis here: one mesh axis cannot carry both (the "
            "machine-stacked spec would name 'data' twice)")
    return machine_map(mesh), payload_for(model, mesh)


def split_machines(batch: Dict[str, torch.Tensor],
                   m: int) -> Dict[str, torch.Tensor]:
    """The global batch on a leading machine axis, ``(m, B/m, ...)`` per
    entry (views): machine i holds rows [i*B/m, (i+1)*B/m)."""
    B = next(iter(batch.values())).shape[0]
    if B % m:
        raise ValueError(f"global batch {B} does not split over {m} "
                         f"machines")
    return {k: v.reshape((m, B // m) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _value_and_grad(model: Model, leaves, treedef, mb):
    """One machine's loss and gradient at ``leaves``; under a payload
    sharding from this rank's rows of ``mb``, averaged over the model
    group."""
    pl = active_payload()
    if pl is not None:
        mb = pl.rows(mb)
    p = tree_unflatten(treedef, leaves)
    with obs.span("repro.model"), torch.enable_grad():
        loss, _ = model.loss(mb, params=p)
        grads = torch.autograd.grad(loss, leaves)
    if pl is not None:
        return pl.finish(loss.detach(), grads)
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
                  tcfg: TrainConfig,
                  machine_map: AllMachines = ALL_MACHINES):
    """``(losses (m,), grads)``: every machine's loss and the gradient tree
    of ``params``' shape with leaves ``(m, *leaf)``, in the parameters'
    dtype (f32 with microbatches; then cast to ``tcfg.grad_dtype`` where
    set) — the reference's ``jax.vmap(machine_grad)``. With a machine map
    over ranks, the leaves hold this rank's machines only, ``(m / world,
    *leaf)``; the losses are gathered."""
    leaves, treedef = tree_flatten(params)
    leaves = [x if x.requires_grad else x.detach().requires_grad_()
              for x in leaves]
    split = {k: machine_map.local(v) for k, v in
             split_machines(batch, tcfg.n_machines).items()}
    k_local = next(iter(split.values())).shape[0]
    bufs = [torch.empty((k_local,) + tuple(x.shape),
                        dtype=torch.float32 if tcfg.microbatch else x.dtype,
                        device=x.device) for x in leaves]
    losses = machine_map.gather(torch.stack([
        _machine_grad(model, leaves, treedef,
                      {k: v[i] for k, v in split.items()}, bufs, i,
                      tcfg.microbatch)
        for i in range(k_local)]))
    if tcfg.grad_dtype:
        dt = _DTYPES[tcfg.grad_dtype]
        bufs = [b.to(dt) for b in bufs]
    return losses, tree_unflatten(treedef, bufs)


def make_loss_fn(model: Model, remat: bool = True):
    """``loss_fn(params, batch) -> (loss, aux)``: ``Model.loss`` at the
    given parameters, the reference's argument order (``remat`` is the
    model's own, as there)."""
    def loss_fn(params, batch):
        return model.loss(batch, params=params)
    return loss_fn


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
    ``agg``. With a ``mesh`` each rank computes its machines' gradients
    and the wire gathers every leaf (``dist.grad_agg``); ``key`` must be
    seeded alike on every rank. On a mesh with a "model" axis,
    ``params``, ``opt_state`` and ``agg`` hold this rank's slices
    (``train_step.payload.shard`` cuts a whole tree), while ``noise`` and
    ``attack_noise`` are whole leaves, cut here."""
    mm, pl = _mesh_plan(mesh, model, tcfg.fsdp)
    if pl is not None:
        from repro_torch.dist.collectives import check_spec
        check_spec(tcfg.agg, (None, "model"))

    def train_step(params, opt_state, batch, key=None, byz_mask=None, *,
                   noise=None, attack_noise=None, with_agg=False):
        with obs.span("repro.step", timed=True), maybe_active(pl):
            losses, grads = machine_grads(model, params, batch, tcfg, mm)
            specs = None
            if mesh is not None and tcfg.agg.strategy == "sharded":
                from repro_torch.dist.collectives import tree_machine_specs
                specs = tree_machine_specs(
                    grads if pl is None else pl.full_like(grads), mesh,
                    fsdp=tcfg.fsdp)
            agg = robust_aggregate(grads, tcfg.agg, key, byz_mask,
                                   mesh=mesh, machine_specs=specs,
                                   noise=noise, attack_noise=attack_noise)
            del grads           # the (m, *leaf) buffers, before AdamW's
            updates, opt_state = opt.update(agg, opt_state, params)
            params = apply_updates(params, updates)
            del updates
            metrics = {"loss": losses.mean(), "loss_per_machine": losses,
                       "grad_norm": global_norm(agg)}
        if with_agg:
            metrics["agg"] = agg
        return params, opt_state, metrics

    train_step.payload = pl
    return train_step


class Trainer:
    """The loop: batches in, one robust-DP step each, a DP ledger out."""

    def __init__(self, model: Model, opt: AdamW, tcfg: TrainConfig,
                 mesh=None):
        self.model, self.opt, self.tcfg = model, opt, tcfg
        self.step_fn = make_train_step(model, opt, tcfg, mesh)
        #: the payload sharding (None: every leaf whole on this rank)
        self.payload = self.step_fn.payload
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
        per_step = spend_record(
            params if self.payload is None
            else self.payload.full_like(params), self.tcfg.agg,
            name="grad step")
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

def make_grad_fn(model: Model):
    """``grad_fn(params, batch) -> (loss, grad tree)``: one machine's loss
    and its gradient at ``params`` (any tree of ``Model.params()``'s
    shape), the protocol engine's ``grad_fn``."""
    def grad_fn(params, mb):
        leaves, treedef = tree_flatten(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        loss, grads = _value_and_grad(model, leaves, treedef, mb)
        return loss, tree_unflatten(treedef, list(grads))
    return grad_fn


@dataclasses.dataclass(frozen=True)
class QNTrainConfig:
    """Robust DP quasi-Newton training: every optimizer step is one run of
    Algorithm 1's five transmissions over the parameter tree."""
    n_machines: int = 4
    protocol: TreeProtocolConfig = dataclasses.field(
        default_factory=TreeProtocolConfig)
    attack: str = "none"           # repro_torch.attacks registry name/alias
    attack_factor: float = -3.0
    remat: bool = True


def make_qn_train_step(model: Model, qcfg: QNTrainConfig, mesh=None):
    """Returns ``train_step(params, mem, batch, key=None, byz_mask=None, *,
    sigmas=None, noise=None, attack_noise=None) -> (params, mem,
    metrics)``: one five-transmission protocol step
    (``core.protocol.protocol_tree_rounds``) with ``grad_fn`` one
    ``torch.autograd.grad`` of the machine's loss. ``params`` (a tree of
    ``Model.params()``'s shape) is set to theta_qn in place; ``mem`` is the
    per-machine L-BFGS history (``LBFGSMemory.init_like(hist, params,
    machines=m)``), also updated in place. ``n`` for the per-leaf DP
    calibration is the number of batch rows per machine. ``key``,
    ``sigmas``, ``noise`` and ``attack_noise`` go to the engine.
    ``metrics``: ``loss`` (the machines' mean), ``loss_per_machine`` (m,)
    and ``grad_norm`` (of g_cq), device tensors. With a ``mesh`` each rank
    runs its own machines and ``mem`` holds theirs, ``m / world``
    machines (``QNTrainer.init_memory``); with a "model" axis ``params``
    and ``mem`` hold this rank's slices, as in :func:`make_train_step`."""
    mm, pl = _mesh_plan(mesh, model)
    if pl is not None:
        from repro_torch.dist.collectives import check_spec
        check_spec(GradAggConfig(method=qcfg.protocol.aggregator),
                   (None, "model"))
    m = qcfg.n_machines
    grad_fn = make_grad_fn(model)

    def train_step(params, mem, batch, key=None, byz_mask=None, *,
                   sigmas=None, noise=None, attack_noise=None):
        with obs.span("repro.step", timed=True):
            mb = split_machines(batch, m)
            with maybe_active(pl):
                out = protocol_tree_rounds(
                    key, params, mb, grad_fn, qcfg.protocol, mem=mem,
                    byz_mask=byz_mask, attack=qcfg.attack,
                    attack_factor=qcfg.attack_factor, sigmas=sigmas,
                    n=next(iter(mb.values())).shape[1], noise=noise,
                    attack_noise=attack_noise, machine_map=mm)
            with torch.no_grad():
                for p, q in zip(tree_leaves(params),
                                tree_leaves(out.theta_qn)):
                    p.copy_(q)
            metrics = {"loss": out.losses.mean(),
                       "loss_per_machine": out.losses,
                       "grad_norm": out.grad_norm}
        return params, out.mem, metrics

    train_step.payload = pl
    return train_step


class QNTrainer:
    """The protocol-driven loop: the model trained by the same engine as
    the convex head (five DP transmissions, registry attacks and
    aggregators, per-leaf calibrated noise, L-BFGS curvature memory)."""

    def __init__(self, model: Model, qcfg: QNTrainConfig, mesh=None):
        self.model, self.qcfg = model, qcfg
        self.world = _mesh_plan(mesh, model)[0].world
        self.step_fn = make_qn_train_step(model, qcfg, mesh)
        #: the payload sharding (None: every leaf whole on this rank)
        self.payload = self.step_fn.payload

    def init_memory(self, params: Any) -> LBFGSMemory:
        """An empty memory of this rank's machines (all of them without a
        mesh)."""
        return LBFGSMemory.init_like(
            self.qcfg.protocol.hist, params,
            machines=self.qcfg.n_machines // self.world)

    def fit(self, params: Any, batches: Iterable[Dict[str, torch.Tensor]],
            key: Optional[torch.Generator] = None, byz_mask=None,
            log_every: int = 10, callback=None):
        """Train on ``batches`` from an empty memory; returns ``(params,
        mem, history)`` with ``history`` the logged ``{step, loss}``
        entries. ``key`` (a generator) feeds every step's draws."""
        mem = self.init_memory(params)
        history = []
        for i, batch in enumerate(batches):
            params, mem, metrics = self.step_fn(params, mem, batch, key,
                                                byz_mask)
            if i % log_every == 0 or callback:
                history.append({"step": i, "loss": float(metrics["loss"])})
                if callback:
                    callback(i, metrics)
        return params, mem, history
