"""The protocol's wire: noise, corrupt and aggregate primitives —
``repro/core/transport.py`` counterpart, flat single-array path only.

Algorithm 1's wire model: a per-machine statistic is stacked along a
machine axis, DP noise is added per machine, Byzantine corruption replaces
the selected rows, and a robust aggregator reduces the machine axis.

Layout: ``values`` is ``(*B, m, p)`` with the machine axis second to last;
leading axes are batch (the Monte-Carlo replicate axis). A 1-D ``(m,)``
stack is a statistic with an empty payload. An ``(m, p)`` array is the
reference's layout exactly. The pytree wire of the model-scale engine
belongs to a later slice.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch import agg, attacks
from repro_torch.attacks.rules import Key

__all__ = ["wire_noise", "wire_corrupt", "wire_aggregate"]


def _bcast_sigma(sig, values: torch.Tensor):
    """A number, or a per-machine sigma tensor whose LAST axis is the
    machine axis (size m, or 1 for one sigma per batch row), broadcast over
    the payload axis."""
    if not isinstance(sig, torch.Tensor) or sig.dim() == 0:
        return sig
    return sig.to(values.dtype).unsqueeze(-1)


def wire_noise(z: torch.Tensor, values: torch.Tensor,
               sigma: Union[float, torch.Tensor]) -> torch.Tensor:
    """Gaussian mechanism on the wire: ``values + sigma * z``, one draw per
    machine row and coordinate.

    ``z``: standard normals shaped like the noised output, which may carry
    batch axes that ``values`` broadcasts over (the reference draws them
    from its transmission key; the protocol from its generator or the
    caller's draws). ``sigma``: a number, or per-machine ``(*B, m)``.
    """
    z = z.to(dtype=values.dtype, device=values.device)
    return values + _bcast_sigma(sigma, values) * z


def wire_corrupt(key: Optional[Key], values: torch.Tensor,
                 byz_mask: Optional[torch.Tensor], attack: str = "scale",
                 factor=-3.0, round_idx: int = 0) -> torch.Tensor:
    """Byzantine corruption of the machine rows selected by ``byz_mask
    (m,)`` through the ``repro_torch.attacks`` registry. ``values`` is
    ``(*B, m, p)``; omniscient attacks see each batch row's full machine
    axis. ``key`` (attacks that draw) is a generator or standard normals
    shaped like ``values``."""
    if byz_mask is None or attacks.resolve(attack) == "none":
        return values
    k = key.movedim(-2, 0) if isinstance(key, torch.Tensor) else key
    out = attacks.apply_attack(values.movedim(-2, 0), byz_mask,
                               attack=attack, factor=factor, key=k,
                               round_idx=round_idx)
    return out.movedim(0, -2)


def wire_aggregate(values: torch.Tensor, method: str, scale=None,
                   K: int = 10, trim_beta: float = 0.2) -> torch.Tensor:
    """Robust aggregation of the machine axis through the
    ``repro_torch.agg`` registry: ``(m,) -> ()`` or ``(*B, m, p) ->
    (*B, p)`` with ``scale`` shaped like the result. The whole batch is one
    kernel launch on a CUDA tensor."""
    if values.dim() == 1:
        return agg.aggregate(values, method=method, scale=scale, K=K,
                             trim_beta=trim_beta, axis=0)
    return agg.aggregate_batched(values, method=method, scale=scale, K=K,
                                 trim_beta=trim_beta)
