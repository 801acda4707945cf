"""``repro_torch.attacks`` — the registry-backed threat models
(``repro.attacks`` counterpart).

Dispatch contract (``apply_attack``): the rule produces replacement rows
for the whole ``(m, ...)`` stack and ``torch.where(mask, bad, values)``
puts them only on the Byzantine rows, so honest transmissions come back
bit-unchanged whatever the attack. ``attack="none"`` returns the input
object untouched.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.attacks import registry, rules
from repro_torch.attacks.registry import (ALIASES, Attack, get_attack,
                                          needs_key, register, registered,
                                          resolve, unregister)
from repro_torch.attacks.rules import (N_PROTOCOL_ROUNDS, Key,
                                       adaptive_scale_attack, alie_attack,
                                       byzantine_mask, gaussian_attack,
                                       honest_mean_std, ipm_attack,
                                       random_value_attack, scaling_attack,
                                       sign_flip_attack, zero_attack)

__all__ = [
    "Attack", "register", "unregister", "get_attack", "registered",
    "resolve", "needs_key", "ALIASES",
    "apply_attack", "byzantine_mask", "honest_mean_std",
    "N_PROTOCOL_ROUNDS",
    "scaling_attack", "sign_flip_attack", "gaussian_attack",
    "random_value_attack", "zero_attack", "adaptive_scale_attack",
    "alie_attack", "ipm_attack",
    "registry", "rules",
]


# ------------------------------------------------------- built-in attacks
#
# corrupt signature: (values, mask, factor, key) -> replacement rows
# (round-aware rules take an extra ``round_idx`` keyword).

register(Attack(
    name="none",
    corrupt=lambda values, mask, factor, key: values,
    factor_grid=(),
    doc="no corruption (the honest-execution control)"))

register(Attack(
    name="scale",
    corrupt=lambda values, mask, factor, key:
        rules.scaling_attack(values, factor),
    factor_grid=(-10.0, -3.0, 3.0, 10.0),
    doc="transmit factor x the true statistic (paper §5.1: -3/+3)"))

register(Attack(
    name="signflip",
    corrupt=lambda values, mask, factor, key:
        rules.sign_flip_attack(values),
    factor_grid=(1.0,),
    doc="transmit the negated statistic (factor ignored)"))

register(Attack(
    name="gauss",
    corrupt=lambda values, mask, factor, key:
        rules.gaussian_attack(values, key, sigma=abs(factor)),
    needs_key=True,
    factor_grid=(3.0, 10.0, 30.0),
    doc="additive N(0, sigma^2) noise with sigma = |factor|"))

register(Attack(
    name="random",
    corrupt=lambda values, mask, factor, key:
        rules.random_value_attack(values, key, scale=abs(factor)),
    needs_key=True,
    factor_grid=(3.0, 10.0, 30.0),
    doc="replace with |factor| x N(0, 1) garbage"))

register(Attack(
    name="zero",
    corrupt=lambda values, mask, factor, key:
        rules.zero_attack(values),
    factor_grid=(1.0,),
    doc="transmit zeros: silent drop-out / free-rider (factor ignored)"))

register(Attack(
    name="adaptive_scale",
    corrupt=lambda values, mask, factor, key, round_idx=0:
        rules.adaptive_scale_attack(values, factor, round_idx=round_idx),
    round_aware=True,
    factor_grid=(-10.0, -3.0, 3.0),
    doc="scaling ramping 1x -> factor x over Algorithm 1's rounds"))

register(Attack(
    name="alie",
    corrupt=lambda values, mask, factor, key:
        rules.alie_attack(values, mask, z=factor),
    omniscient=True,
    factor_grid=(0.5, 1.0, 2.0),
    doc="'a little is enough' (Baruch et al. 2019): honest_mean - "
        "factor x honest_std"))

register(Attack(
    name="ipm",
    corrupt=lambda values, mask, factor, key:
        rules.ipm_attack(values, mask, eps=factor),
    omniscient=True,
    factor_grid=(0.5, 1.5, 10.0),
    doc="inner-product manipulation (Xie et al. 2020): -factor x "
        "honest_mean"))


# ------------------------------------------------------------ dispatch API

def apply_attack(values: torch.Tensor, mask: torch.Tensor,
                 attack: str = "scale", factor=-3.0,
                 key: Optional[Key] = None,
                 round_idx: int = 0) -> torch.Tensor:
    """Corrupt the machine-axis rows of ``values (m, ...)`` selected by
    ``mask (m,)``; honest rows come back bit-identical. ``key`` is a
    ``torch.Generator`` or pre-drawn standard normals shaped like
    ``values``, for the attacks that draw randomness.

    Raises ``ValueError`` for an unregistered attack, or when a
    randomness-consuming attack is dispatched without ``key``.
    """
    name = resolve(attack)
    if name == "none":
        return values
    try:
        entry = get_attack(name)
    except KeyError as e:
        raise ValueError(e.args[0]) from None
    if entry.needs_key and key is None:
        raise ValueError(
            f"attack {entry.name!r} draws randomness (needs_key=True) but "
            f"apply_attack was called with key=None; pass a "
            f"torch.Generator or pre-drawn standard normals")
    kw = {"round_idx": round_idx} if entry.round_aware else {}
    bad = entry.corrupt(values, mask, factor, key, **kw)
    sel = mask.reshape((-1,) + (1,) * (values.dim() - 1))
    return torch.where(sel, bad, values)
