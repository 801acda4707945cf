"""Plain PyTorch oracles of every registered aggregator —
``repro/agg/reference.py`` counterpart.

The numerical oracle the CUDA kernel (``repro_torch.agg.kernel``) is held
against, and the backend of ``repro_torch.agg.aggregate`` on CPU tensors.
Coordinate-wise rules take the machine axis as ``axis``; every other
dimension is payload and batches natively.

The median is sort-and-average: for an even count it is the mean of the
two middle values, as ``jnp.median``; ``torch.median`` would return the
lower one.

DCQ (paper §3, eq. (3.1)/(4.4)): with m machine statistics ``Y_1..Y_m``,

    med  = med{Y_j}
    S    = sum_k sum_j [ I(Y_j <= med + scale*Delta_k) - kappa_k ]
    DCQ  = med - scale * S / (m * sum_k g(Delta_k))

with ``kappa_k = k/(K+1)`` and ``Delta_k = G^{-1}(kappa_k)``, G the
standard normal.
"""
from __future__ import annotations

import math

import torch

#: MAD -> sd consistency factor for the normal reference distribution.
MAD_SIGMA = 1.4826
#: floor added to MAD scales so all-identical columns stay finite.
MAD_EPS = 1e-12


# ------------------------------------------------------- DCQ quantile theory

def quantile_levels(K: int, device=None) -> torch.Tensor:
    """kappa_k = k/(K+1), k = 1..K, in float32."""
    return torch.arange(1, K + 1, dtype=torch.float32, device=device) / (K + 1)


def quantile_knots(K: int, device=None) -> torch.Tensor:
    """Delta_k = Psi^{-1}(kappa_k) for the standard-normal reference G."""
    return torch.special.ndtri(quantile_levels(K, device))


def _norm_pdf(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)


def d_k(K: int) -> float:
    """Variance inflation D_K of the DCQ estimator vs the mean (centred
    form), in float32 as the reference computes it.

    ARE(DCQ vs mean) = 1/D_K ; K -> inf gives D_K -> pi/3 (ARE 3/pi ~ 0.955).
    """
    kappa = quantile_levels(K)
    delta = quantile_knots(K)
    num = (torch.minimum(kappa[:, None], kappa[None, :])
           - kappa[:, None] * kappa[None, :]).sum()
    den = _norm_pdf(delta).sum() ** 2
    return float(num / den)


def are_dcq(K: int) -> float:
    """Asymptotic relative efficiency of DCQ vs the sample mean."""
    return 1.0 / d_k(K)


#: ARE of the median vs the mean, 2/pi ~ 0.637 (quoted in the paper §1)
ARE_MEDIAN = 2.0 / math.pi


# ----------------------------------------------------- simple aggregators

def mean_agg(values: torch.Tensor, axis: int = 0) -> torch.Tensor:
    return values.mean(dim=axis)


def median_agg(values: torch.Tensor, axis: int = 0) -> torch.Tensor:
    srt = values.sort(dim=axis).values
    m = srt.shape[axis]
    if m % 2 == 1:
        return srt.select(axis, (m - 1) // 2)
    return (srt.select(axis, m // 2 - 1) + srt.select(axis, m // 2)) * 0.5


def trimmed_mean_agg(values: torch.Tensor, beta: float = 0.2,
                     axis: int = 0) -> torch.Tensor:
    """Coordinate-wise beta-trimmed mean (Yin et al. 2018 convention): drop
    the floor(beta*m) smallest and the floor(beta*m) largest entries per
    coordinate and average the rest."""
    values = values.movedim(axis, 0)
    m = values.shape[0]
    g = max(int(beta * m), 0)
    if 2 * g >= m:
        raise ValueError(f"trim fraction {beta} too large for m={m}")
    srt = values.sort(dim=0).values
    return srt[g:m - g].mean(dim=0)


def geometric_median_agg(values: torch.Tensor, axis: int = 0,
                         iters: int = 50, eps: float = 1e-8) -> torch.Tensor:
    """Weiszfeld iteration for the geometric median of m vectors. Not
    coordinate-wise: the weights couple all coordinates."""
    values = values.movedim(axis, 0)                     # (m, ...)
    m = values.shape[0]
    flat = values.reshape(m, -1)
    z = median_agg(flat, 0)
    for _ in range(iters):
        d = torch.linalg.vector_norm(flat - z.unsqueeze(0), dim=1)
        w = 1.0 / d.clamp_min(eps)
        z = (w.unsqueeze(1) * flat).sum(0) / w.sum()
    return z.reshape(values.shape[1:])


# --------------------------------------------------------------- DCQ rules

def dcq(values: torch.Tensor, scale: torch.Tensor, K: int = 10,
        axis: int = 0) -> torch.Tensor:
    """Coordinate-wise DCQ estimate over the machine axis.

    ``scale`` is the per-coordinate s.d. of one machine's statistic, shaped
    like ``values`` without ``axis``. Returns that shape.
    """
    values = values.movedim(axis, 0)
    m = values.shape[0]
    dt = values.dtype
    med = median_agg(values, 0)
    delta = quantile_knots(K, values.device).to(dt)           # (K,)
    kappa = quantile_levels(K, values.device).to(dt)          # (K,)
    thr = med.unsqueeze(0) + scale.unsqueeze(0) \
        * delta.reshape((K,) + (1,) * med.dim())                # (K, ...)
    ind = (values.unsqueeze(0) <= thr.unsqueeze(1)).to(dt)    # (K, m, ...)
    s = (ind - kappa.reshape((K,) + (1,) * values.dim())).sum(dim=(0, 1))
    denom = m * _norm_pdf(delta).sum()
    return med - scale * s / denom


def dcq_with_sigma(values: torch.Tensor, scale: torch.Tensor, K: int = 10,
                   axis: int = 0):
    """DCQ estimate plus its asymptotic s.d. sigma_cq/sqrt(m) (Thm 3.1)."""
    est = dcq(values, scale, K=K, axis=axis)
    like = dict(dtype=values.dtype, device=values.device)
    m = torch.tensor(values.shape[axis], **like)
    sd = torch.tensor(d_k(K), **like).sqrt() * scale / m.sqrt()
    return est, sd


def dcq_mad_reference(values: torch.Tensor, K: int = 10,
                      axis: int = 0) -> torch.Tensor:
    """MAD-scaled DCQ: median anchor, 1.4826*MAD scale, CQ correction.
    Computes and returns float32."""
    return median_mad_dcq_reference(values, K=K, axis=axis)[2]


def median_mad_dcq_reference(values: torch.Tensor, K: int = 10,
                             axis: int = 0):
    """``(median, raw MAD, MAD-scaled DCQ)`` over the machine axis, in
    float32 (the kernel's fused pass computes all three at once)."""
    values = values.movedim(axis, 0).to(torch.float32)
    med = median_agg(values, 0)
    mad = median_agg((values - med.unsqueeze(0)).abs(), 0)
    scale = MAD_SIGMA * mad + MAD_EPS
    return med, mad, dcq(values, scale, K=K, axis=0)


def median_deviation_variance(values: torch.Tensor, n, axis: int = 0,
                              floor: float = 1e-12) -> torch.Tensor:
    """The untrusted-center variance estimate of Algorithm 1 (§4.3):
    ``max(median((v - median(v))^2) * n, floor)`` per coordinate."""
    values = values.movedim(axis, 0)
    med = median_agg(values, 0)
    return (median_agg((values - med) ** 2, 0) * n).clamp_min(floor)
