"""Pure corruption rules behind the attack registry —
``repro/attacks/rules.py`` counterpart.

Every rule maps the transmitted stack ``values (m, ...)`` (machine axis
first, any trailing dims) to the adversarial replacement rows; the
dispatcher masks them back onto the Byzantine rows.

Randomness: ``gaussian_attack`` and ``random_value_attack`` take ``key`` as
either a ``torch.Generator`` (port-native draws) or a pre-drawn
standard-normal tensor shaped like ``values`` (the reference's draws,
handed over by a parity test).
"""
from __future__ import annotations

from typing import Tuple, Union

import torch

#: Algorithm 1 performs five p-vector transmissions; round-aware rules
#: ramp over round_idx 0..N_PROTOCOL_ROUNDS-1.
N_PROTOCOL_ROUNDS = 5

Key = Union[torch.Generator, torch.Tensor]


def standard_normal(key: Key, like: torch.Tensor) -> torch.Tensor:
    """Standard normals shaped like ``like``: drawn from a generator, or a
    pre-drawn tensor checked for shape and moved to ``like``."""
    if isinstance(key, torch.Generator):
        return torch.randn(like.shape, generator=key, dtype=like.dtype,
                           device=like.device)
    if tuple(key.shape) != tuple(like.shape):
        raise ValueError(f"pre-drawn normals of shape {tuple(key.shape)} "
                         f"for values of shape {tuple(like.shape)}")
    return key.to(dtype=like.dtype, device=like.device)


def byzantine_mask(generator: torch.Generator, m: int,
                   alpha: float) -> torch.Tensor:
    """Choose floor(alpha*m) of m machines at random (the caller decides
    the indexing relative to the center)."""
    n_byz = int(alpha * m)
    perm = torch.randperm(m, generator=generator,
                          device=generator.device)
    mask = torch.zeros((m,), dtype=torch.bool, device=generator.device)
    mask[perm[:n_byz]] = True
    return mask


def honest_mean_std(values: torch.Tensor,
                    mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-coordinate mean/std over the HONEST rows (mask False). An
    all-Byzantine mask degenerates to (0, 0) instead of dividing by 0."""
    honest = (~mask).to(values.dtype)
    honest = honest.reshape((-1,) + (1,) * (values.dim() - 1))
    count = honest.sum(dim=0).clamp_min(1.0)
    mean = (values * honest).sum(dim=0) / count
    var = (((values - mean) ** 2) * honest).sum(dim=0) / count
    return mean, torch.sqrt(var)


# ------------------------------------------------------------- wire attacks

def scaling_attack(values: torch.Tensor, factor: float = -3.0):
    return factor * values


def sign_flip_attack(values: torch.Tensor):
    return -values


def gaussian_attack(values: torch.Tensor, key: Key, sigma: float = 10.0):
    return values + sigma * standard_normal(key, values)


def random_value_attack(values: torch.Tensor, key: Key, scale: float = 10.0):
    return scale * standard_normal(key, values)


def zero_attack(values: torch.Tensor):
    return torch.zeros_like(values)


def adaptive_scale_attack(values: torch.Tensor, factor: float,
                          round_idx: int = 0):
    """Scaling coefficient ramps linearly over the protocol's rounds:
    1x at round_idx 0 up to ``factor`` x at the final round, clamped
    beyond it."""
    ramp = (torch.tensor(round_idx, dtype=values.dtype,
                         device=values.device)
            / (N_PROTOCOL_ROUNDS - 1)).clamp_max(1.0)
    coeff = 1.0 + (factor - 1.0) * ramp
    return coeff * values


# ------------------------------------------------------- omniscient attacks

def alie_attack(values: torch.Tensor, mask: torch.Tensor, z: float = 1.0):
    """'A little is enough': ``z`` honest standard deviations below the
    honest mean, inside the honest spread."""
    mean, std = honest_mean_std(values, mask)
    return (mean - z * std).expand(values.shape)


def ipm_attack(values: torch.Tensor, mask: torch.Tensor, eps: float = 1.0):
    """Inner-product manipulation: the negated (scaled) honest mean."""
    mean, _ = honest_mean_std(values, mask)
    return (-eps * mean).expand(values.shape)
