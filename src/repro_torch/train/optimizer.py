"""Minimal tree optimizers (AdamW, SGD with momentum) —
``repro/train/optimizer.py`` counterpart.

The reference's optax-like API: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, state)``, applied with
``apply_updates``. Trees are the reference's (nested dicts of tensors, see
``repro_torch.core.transport``); the state holds f32 moments shaped like
the parameters and an int step.

Not ``torch.optim.AdamW``: the reference clips by the global norm inside
``update``, computes the update in f32 and casts it to the parameter's
dtype before ``p + u``, and puts ``eps`` outside ``sqrt(v / bc2)``; all
three change bf16 numbers. The clip scale stays a device tensor (no host
sync per step). ``update`` writes the moments in place (the returned
state holds the same tensors) and ``apply_updates`` writes the parameters
in place, where the reference returns new trees: at full width a second
copy of the moments is 13 GB.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import obs
from repro_torch.core.transport import (leaf_sum, tree_flatten,
                                        tree_leaves, tree_map,
                                        tree_unflatten)

__all__ = ["AdamW", "AdamWState", "SGD", "SGDState", "apply_updates",
           "global_norm"]


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # an f32 device scalar: the reference's constants are f32 in the trace
    # repro-torch: allow(step-sync) — step sync kept: the clip threshold
    # copied to the card as an f32 scalar, once a step (the card reports it)
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0        # global-norm clip; 0 disables

    def init(self, params: Any) -> AdamWState:
        return AdamWState(step=0, mu=tree_map(_zeros_f32, params),
                          nu=tree_map(_zeros_f32, params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        leaves = tree_leaves(params)
        scale = None
        with obs.span("repro.optim"):
            if self.grad_clip > 0:
                gnorm = global_norm(grads)
                scale = torch.clamp(torch.div(_f32(self.grad_clip, gnorm),
                                              gnorm + 1e-9), max=1.0)
            b1, b2 = self.b1, self.b2
            # the bias corrections 1 - b^t in f32, as in the reference's
            # trace, as device scalars: a division by a Python number may
            # become a reciprocal multiply on the card
            # repro-torch: allow(step-sync) — host-only: the step count is a
            # Python int, made into a host tensor
            t = torch.tensor(float(step), dtype=torch.float32)
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
            updates = []
            for p, g, m, v in zip(leaves, tree_leaves(grads),
                                  tree_leaves(state.mu),
                                  tree_leaves(state.nu)):
                # repro-torch: allow(step-sync) — step sync kept: the host's
                # bias corrections copied to each leaf's device, twice a
                # leaf a step (the card reports it)
                bc1_, bc2_ = bc1.to(p.device), bc2.to(p.device)
                # the clipped gradient is f32 (a bf16 leaf times the f32
                # scale)
                g32 = g.to(torch.float32)
                if scale is not None:
                    g32 = g32 * scale     # a new tensor: g stays as it was
                m.mul_(b1).add_(g32, alpha=1 - b1)
                v.mul_(b2).addcmul_(g32, g32, value=1 - b2)
                del g32
                den = torch.div(v, bc2_).sqrt_().add_(self.eps)
                u = torch.div(m, bc1_).mul_(-self.lr).div_(den)
                del den
                if self.weight_decay > 0:
                    u.sub_(p.to(torch.float32),
                           alpha=self.lr * self.weight_decay)
                updates.append(u.to(p.dtype))
                del u
        upd = tree_unflatten(tree_flatten(params)[1], updates)
        return upd, AdamWState(step=step, mu=state.mu, nu=state.nu)


class SGDState(NamedTuple):
    step: int
    mom: Any


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 0.1
    momentum: float = 0.9

    def init(self, params: Any) -> SGDState:
        return SGDState(step=0, mom=tree_map(_zeros_f32, params))

    @torch.no_grad()
    def update(self, grads: Any, state: SGDState, params: Any
               ) -> Tuple[Any, SGDState]:
        def mom(m, g):
            return m.mul_(self.momentum).add_(g.to(torch.float32))
        new = tree_map(mom, state.mom, grads)
        updates = tree_map(lambda p, m: (m * -self.lr).to(p.dtype), params,
                           new)
        return updates, SGDState(step=state.step + 1, mom=new)


@torch.no_grad()
def apply_updates(params: Any, updates: Any) -> Any:
    """``p + u`` leaf by leaf, written into ``params`` (returned)."""
    with obs.span("repro.optim"):
        return tree_map(lambda p, u: p.add_(u), params, updates)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32, on the device
    (the whole tree's under a payload sharding: ``leaf_sum``)."""
    leaves = tree_leaves(tree)
    total = leaf_sum([leaf.to(torch.float32).square().sum()
                      for leaf in leaves])
    return torch.sqrt(total)
