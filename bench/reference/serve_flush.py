"""The served model's round, plain: the ring buffer's rows noised by the
round's Gaussian mechanism, aggregated coordinate by coordinate over the
machines, and the served theta moved against the aggregate.

    rows  = updates + sigma * z       z ~ N(0, 1), drawn in float32 from
                                      the generator of the round's stream
    agg   = dcq_mad(rows)             (``agg.dcq_mad``, in ``dtype``)
    theta = theta - lr * agg

The round's generator is seeded, as the service states, with the first
63 bits of the SHA-256 of ``"<seed>/5/<round>"`` (5: the "serve" stream).
``sigma`` is the mean mechanism's at the served theta's dimension
(``bench.lib.dp.sigma``). The aggregation runs in float64 for the check
and in bfloat16 for the control.
"""
from __future__ import annotations

import hashlib

import torch

from bench.reference import agg

SERVE_STREAM = 5


def round_seed(seed: int, round_idx: int) -> int:
    tag = f"{int(seed)}/{SERVE_STREAM}/{int(round_idx)}"
    return int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8],
                          "big") >> 1


def noised_rows(updates: torch.Tensor, seed: int, round_idx: int,
                sigma: float) -> torch.Tensor:
    g = torch.Generator(device=updates.device).manual_seed(
        round_seed(seed, round_idx))
    z = torch.randn(updates.shape, generator=g, dtype=updates.dtype,
                    device=updates.device).mul_(sigma)
    return updates + z


def round_step(updates: torch.Tensor, seed: int, round_idx: int,
               sigma: float, lr: float, K: int = 10, dtype=torch.float64,
               fault=None):
    """``(-lr * agg, scale)`` of one round: the move of theta, and the
    aggregate's natural scale per coordinate (1.4826 MAD of the noised
    rows), both in ``dtype``. ``fault`` plants one of the faults the
    check must catch: "half" (the aggregate of the first half of the
    rows), "alter" (the first coordinate of the aggregate doubled),
    "nonoise" (sigma 0), "sigma2" (sigma doubled)."""
    sigma *= {"nonoise": 0.0, "sigma2": 2.0}.get(fault, 1.0)
    rows = noised_rows(updates, seed, round_idx, sigma).to(dtype)
    med = agg.median(rows)
    scale = agg.MAD_SIGMA * agg.median((rows - med).abs())
    if fault == "half":
        rows = rows[:rows.shape[0] // 2]
    out = agg.dcq_mad(rows, K, dtype=dtype)
    if fault == "alter":
        out[0] = out[0] * 2
    return -lr * out, scale
