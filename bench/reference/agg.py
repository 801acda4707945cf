"""Coordinate-wise robust aggregation over the machine axis, plain.

``dcq_mad`` (paper §3, eq. (3.1)/(4.4) with a MAD scale): per coordinate,
with m machine values Y_1..Y_m,

    med   = median{Y_j}                (the mean of the two middle values
                                        for even m)
    scale = 1.4826 * median{|Y_j - med|} + 1e-12
    S     = sum_k sum_j [ I(Y_j <= med + scale * Delta_k) - kappa_k ]
    DCQ   = med - scale * S / (m * sum_k phi(Delta_k))

with kappa_k = k / (K + 1), Delta_k the standard normal's kappa_k
quantile and phi its density. Computed in ``dtype`` (float32 by
default, the precision the wire's rule states; float64 for the served
theta's check) over column blocks, so a 620.8M-coordinate leaf never
needs the (K, m, p) indicators at once.
"""
from __future__ import annotations

import math

import torch

MAD_SIGMA = 1.4826
MAD_EPS = 1e-12
BLOCK = 1 << 24


def _levels(K: int, dtype, device):
    kappa = torch.arange(1, K + 1, dtype=torch.float64) / (K + 1)
    delta = torch.special.ndtri(kappa)
    pdf = torch.exp(-0.5 * delta * delta) / math.sqrt(2 * math.pi)
    return (kappa.to(dtype=dtype, device=device),
            delta.to(dtype=dtype, device=device), float(pdf.sum()))


#: up to this many machines the values are ordered by compare-exchange
#: passes (exact, and far faster than a sort of a short axis)
SMALL_M = 8


def sorted_rows(v: torch.Tensor) -> torch.Tensor:
    """``v`` ordered along axis 0."""
    m = v.shape[0]
    if m > SMALL_M:
        return v.sort(dim=0).values
    rows = list(v.unbind(0))
    for r in range(m):                   # odd-even transposition sort
        for i in range(r % 2, m - 1, 2):
            lo = torch.minimum(rows[i], rows[i + 1])
            rows[i + 1] = torch.maximum(rows[i], rows[i + 1])
            rows[i] = lo
    return torch.stack(rows)


def median(v: torch.Tensor) -> torch.Tensor:
    """The median over axis 0."""
    s = sorted_rows(v)
    m = s.shape[0]
    if m % 2:
        return s[m // 2]
    return (s[m // 2 - 1] + s[m // 2]) * 0.5


def _dcq_mad_block(v: torch.Tensor, K: int) -> torch.Tensor:
    m = v.shape[0]
    kappa, delta, pdf_sum = _levels(K, v.dtype, v.device)
    med = median(v)
    scale = MAD_SIGMA * median((v - med).abs()) + MAD_EPS
    s = torch.zeros_like(med)
    for k in range(K):
        thr = med + scale * delta[k]
        s += (v <= thr).to(v.dtype).sum(0) - m * kappa[k]
    return med - scale * s / (m * pdf_sum)


def dcq_mad(values: torch.Tensor, K: int = 10,
            dtype=torch.float32) -> torch.Tensor:
    """``(m, *payload) -> payload`` in ``dtype``."""
    m = values.shape[0]
    flat = values.reshape(m, -1)
    out = torch.empty(flat.shape[1], dtype=dtype, device=values.device)
    for c in range(0, flat.shape[1], BLOCK):
        out[c:c + BLOCK] = _dcq_mad_block(flat[:, c:c + BLOCK].to(dtype), K)
    return out.reshape(values.shape[1:])


def signflip(values: torch.Tensor, byzantine) -> torch.Tensor:
    """The rows of the machines in ``byzantine`` negated, in place."""
    for j in byzantine:
        values[j].neg_()
    return values
