"""Comparison strategies the paper argues against (§1.2(1), §6) —
``repro/core/baselines.py`` counterpart:

  * ``newton_estimator`` — distributed one-step Newton (Huang & Huo 2019
    style): every machine transmits its FULL p x p Hessian + gradient.
    Under DP each of the p^2 entries needs noise, so the per-round privacy
    cost is ~p x that of a vector round — the paper's key budget argument.
  * ``gd_estimator``     — multi-round distributed gradient descent
    (Jordan et al. 2019 style): T rounds of one p-vector each; the privacy
    budget grows linearly in T.

Both use the protocol's wire (``core/transport.py``): noise, corruption
through the attack registry, and the coordinate-wise median at the
center, which on a CUDA tensor is the order-statistics kernel (the
Hessian as one row of p^2 coordinates).

Random draws, as in ``protocol_rounds``: a ``torch.Generator``, or
standard normals keyed by transmission name (``noise``, and
``attack_noise`` for the attacks that draw), shaped like the transmission:
``(m+1, p)``, and ``(m+1, p, p)`` for "R2 hessian". The names follow the
reference's key order, so a parity test can hand over its draws: Newton
splits its key 6 ways into "R1 theta" noise, "R1 theta" attack, "R2 grad"
noise, "R2 hessian" noise, "R2 grad" attack, "R2 hessian" attack; GD
splits it ``2 * rounds`` ways into "GD round t" noise, then attack, for
each t. A generator draws in that same order.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from repro_torch import attacks
from repro_torch.configs.base import ProtocolConfig
from repro_torch.core import dp, local
from repro_torch.core.losses import MEstimationProblem
from repro_torch.core.transport import (wire_aggregate, wire_corrupt,
                                        wire_noise)


@dataclasses.dataclass
class BaselineResult:
    theta: torch.Tensor
    accountant: dp.PrivacyAccountant
    bytes_per_machine: int  # transmitted payload (fp32) for comm comparison


class _Wire:
    """Noise and corruption of one baseline's transmissions, with draws
    from the caller's tables or the generator."""

    def __init__(self, X, cfg, byz_mask, attack, attack_factor, generator,
                 noise, attack_noise):
        self.dev, self.dt = X.device, X.dtype
        self.noiseless = cfg.noiseless
        self.attack, self.factor = attack, attack_factor
        self.generator, self.noise, self.attack_noise = \
            generator, noise, attack_noise
        self.mask = None if byz_mask is None else torch.cat([
            torch.zeros((1,), dtype=torch.bool, device=self.dev),
            torch.as_tensor(byz_mask, device=self.dev).bool()])
        self.draws_attack = self.mask is not None \
            and attacks.resolve(attack) != "none" \
            and attacks.needs_key(attack)
        if not self.noiseless and noise is None and generator is None:
            raise ValueError("a noised run needs a generator or pre-drawn "
                             "noise")
        if self.draws_attack and attack_noise is None and generator is None:
            raise ValueError(f"attack {attack!r} draws randomness: pass a "
                             f"generator or attack_noise")

    def draw(self, table, name, shape):
        if table is None:
            return torch.randn(shape, generator=self.generator,
                               device=self.dev, dtype=self.dt)
        z = torch.as_tensor(table[name], device=self.dev, dtype=self.dt)
        if tuple(z.shape) != tuple(shape):
            raise ValueError(f"draws for {name!r} have shape "
                             f"{tuple(z.shape)}, expected {tuple(shape)}")
        return z

    def noised(self, name, values, sigma):
        if self.noiseless:
            return values
        return wire_noise(self.draw(self.noise, name, values.shape), values,
                          sigma)

    def corrupted(self, name, values, round_idx):
        """Corrupt ``values (m+1, *payload)`` row by row; the payload is
        flattened to one row of coordinates (the attacks are
        coordinate-wise)."""
        if self.mask is None:
            return values
        key = self.draw(self.attack_noise, name, values.shape) \
            .reshape(values.shape[0], -1) if self.draws_attack else None
        out = wire_corrupt(key, values.reshape(values.shape[0], -1),
                           self.mask, attack=self.attack, factor=self.factor,
                           round_idx=round_idx)
        return out.reshape(values.shape)


def _median(values: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median of ``(m+1, *payload)`` over the machines,
    the payload as one row of coordinates: one kernel launch on a CUDA
    tensor."""
    payload = values.shape[1:]
    flat = values.reshape(values.shape[0], -1) if payload else values
    return wire_aggregate(flat, "median").reshape(payload)


def newton_estimator(problem: MEstimationProblem, cfg: ProtocolConfig,
                     X: torch.Tensor, y: torch.Tensor,
                     byz_mask: Optional[torch.Tensor] = None,
                     attack: str = "scale", attack_factor: float = -3.0,
                     theta0: Optional[torch.Tensor] = None, *,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Mapping[str, torch.Tensor]] = None,
                     attack_noise: Optional[Mapping[str, torch.Tensor]]
                     = None) -> BaselineResult:
    """One-step Newton with full-Hessian transmission (2 rounds: theta, then
    grad+Hessian), on the device of ``X`` (m+1, n, p). DP noise on the
    Hessian is calibrated for a p^2-dim query: sensitivity grows by
    sqrt(p) vs a vector (same per-entry tails), which is exactly the
    budget blow-up the paper criticises."""
    m1, n, p = X.shape
    eps_r, delta_r = cfg.eps / 2, cfg.delta / 2
    acct = dp.PrivacyAccountant()
    wire = _Wire(X, cfg, byz_mask, attack, attack_factor, generator, noise,
                 attack_noise)
    if theta0 is None:
        theta0 = torch.zeros((p,), dtype=X.dtype, device=X.device)

    # Round 1: local estimators (same as protocol R1, median init)
    theta_local = local.newton_solve(problem, theta0, X, y,
                                     steps=cfg.newton_steps)
    # lambda_s = None means "calibrate locally" in the protocol; the baseline
    # uses the median local-Hessian eigenvalue as its single constant.
    if cfg.lambda_s is None:
        lam_j = torch.linalg.eigvalsh(
            problem.hessian(theta_local, X, y))[..., 0].clamp_min(1e-3)
        lam = float(_median(lam_j))
    else:
        lam = cfg.lambda_s
    s1 = dp.s1_theta(p, n, cfg.gammas[0], eps_r, delta_r, lam, cfg.tail)
    theta_dp = wire.noised("R1 theta", theta_local, s1)
    theta_dp = wire.corrupted("R1 theta", theta_dp, 0)
    acct.spend("R1 theta", eps_r, delta_r, s1)
    theta_init = _median(theta_dp)

    # Round 2: gradient (p) + full Hessian (p^2) transmission
    grads = problem.grad(theta_init, X, y)                     # (m+1, p)
    hesss = problem.hessian(theta_init, X, y)                  # (m+1, p, p)
    s2g = dp.s2_grad(p, n, cfg.gammas[1], eps_r / 2, delta_r / 2, cfg.tail)
    # Hessian = p^2-dimensional query: Lemma 4.4 sensitivity scales sqrt(dim)
    s2h = dp.s2_grad(p * p, n, cfg.gammas[1], eps_r / 2, delta_r / 2,
                     cfg.tail)
    grads = wire.noised("R2 grad", grads, s2g)
    hesss = wire.noised("R2 hessian", hesss, s2h)
    # final transmission of this 2-round baseline: ramping attacks hit at
    # terminal strength
    last = attacks.N_PROTOCOL_ROUNDS - 1
    grads = wire.corrupted("R2 grad", grads, last)
    hesss = wire.corrupted("R2 hessian", hesss, last)
    acct.spend("R2 grad", eps_r / 2, delta_r / 2, s2g)
    acct.spend("R2 hessian", eps_r / 2, delta_r / 2, s2h)

    g_agg = _median(grads)
    h_agg = _median(hesss)
    eye = torch.eye(p, dtype=X.dtype, device=X.device)
    # symmetrise + ridge for invertibility under heavy DP noise
    h_agg = 0.5 * (h_agg + h_agg.T) + 1e-6 * eye
    # guard: project onto PD cone (noise can flip eigenvalues when p large)
    evals, evecs = torch.linalg.eigh(h_agg)
    h_pd = (evecs * evals.clamp_min(1e-3)) @ evecs.T
    theta = theta_init - torch.linalg.solve(h_pd, g_agg)
    return BaselineResult(theta=theta, accountant=acct,
                          bytes_per_machine=4 * (p + p + p * p))


def gd_estimator(problem: MEstimationProblem, cfg: ProtocolConfig,
                 X: torch.Tensor, y: torch.Tensor, rounds: int = 20,
                 lr: float = 1.0, byz_mask: Optional[torch.Tensor] = None,
                 attack: str = "scale", attack_factor: float = -3.0,
                 theta0: Optional[torch.Tensor] = None, *,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[Mapping[str, torch.Tensor]] = None,
                 attack_noise: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> BaselineResult:
    """T-round distributed GD on the device of ``X``; budget eps/T per
    round so the total matches."""
    m1, n, p = X.shape
    eps_r, delta_r = cfg.eps / rounds, cfg.delta / rounds
    acct = dp.PrivacyAccountant()
    wire = _Wire(X, cfg, byz_mask, attack, attack_factor, generator, noise,
                 attack_noise)
    theta = torch.zeros((p,), dtype=X.dtype, device=X.device) \
        if theta0 is None else theta0
    s2 = dp.s2_grad(p, n, cfg.gammas[1], eps_r, delta_r, cfg.tail)
    for t in range(rounds):
        name = f"GD round {t}"
        grads = wire.noised(name, problem.grad(theta, X, y), s2)
        # round_idx = t: ramping attacks climb over the first protocol-
        # length window of GD rounds, then clamp at full strength
        grads = wire.corrupted(name, grads, t)
        theta = theta - lr * _median(grads)
        acct.spend(name, eps_r, delta_r, s2)
    return BaselineResult(theta=theta, accountant=acct,
                          bytes_per_machine=4 * p * rounds)
