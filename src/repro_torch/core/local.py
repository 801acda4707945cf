"""Machine-local computations: the local M-estimator solve and the
center's variance estimators (Lemma 4.2, eqs. 4.10 and 4.16) —
``repro/core/local.py`` counterpart.

Every function broadcasts over leading batch dimensions the way
``core/losses.py`` does: ``newton_solve`` on ``X (m+1, n, p)`` solves every
machine at once, and the variance plug-ins on ``theta (R, p)`` with the
center's shard ``X (n, p)`` give one estimate per replicate.
"""
from __future__ import annotations

import torch

from repro_torch.core.bfgs import VOp
from repro_torch.core.losses import MEstimationProblem, _xdot


def _eye(p: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(p, dtype=like.dtype, device=like.device)


def newton_solve(problem: MEstimationProblem, theta0: torch.Tensor,
                 X: torch.Tensor, y: torch.Tensor, steps: int = 25,
                 ridge: float = 1e-9) -> torch.Tensor:
    """Damped-Newton solve of the local M-estimation problem, one per
    shard of ``X (*B, n, p)`` from the shared start ``theta0 (p,)``.

    Fixed step count; with the convex GLM losses 25 steps is far past
    quadratic-convergence tolerance.
    """
    p = theta0.shape[-1]
    eye = _eye(p, theta0)
    theta = theta0.expand(X.shape[:-2] + (p,))
    for _ in range(steps):
        g = problem.grad(theta, X, y)
        h = problem.hessian(theta, X, y) + ridge * eye
        # repro-torch: allow(step-sync) — step sync kept: linalg.solve checks
        # its info flag on the host (R1's local Newton fits; the card reports
        # it)
        step = torch.linalg.solve(h, g.unsqueeze(-1)).squeeze(-1)
        # cheap trust region: cap the Newton step length at 5
        norm = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
        step = torch.where(norm > 5.0,
                           step * (torch.full_like(norm, 5.0) / norm), step)
        theta = theta - step
    return theta


def sandwich_diag_variance(problem: MEstimationProblem, theta: torch.Tensor,
                           X: torch.Tensor, y: torch.Tensor,
                           ridge: float = 1e-9) -> torch.Tensor:
    """Lemma 4.2: diag of H^{-1} Cov(grad) H^{-1} at theta, from one shard:
    the asymptotic variance of sqrt(n) (theta_hat_j - theta*)."""
    n, p = X.shape[-2:]
    h = problem.hessian(theta, X, y) + ridge * _eye(p, X)
    # repro-torch: allow(step-sync) — step sync kept: linalg.inv checks its
    # info flag on the host (the card reports it)
    hinv = torch.linalg.inv(h)
    g = problem.per_sample_grads(theta, X, y)           # (*B, n, p)
    gc = g - g.mean(dim=-2, keepdim=True)
    cov = gc.mT @ gc / n                                 # (*B, p, p)
    return torch.diagonal(hinv @ cov @ hinv, dim1=-2, dim2=-1)


def grad_coordinate_variance(problem: MEstimationProblem, theta: torch.Tensor,
                             X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-coordinate variance of nabla f_l(X_i, theta) (§4.1.2): the
    variance of sqrt(n) * nabla F_jl(theta) before DP noise."""
    return problem.grad_variance(theta, X, y)


def _hinv_hess_rows(problem, theta, X, y, u, hinv):
    """Rows ``H0^{-1} hess_i u`` for every sample i, using the GLM
    structure hess_i u = w_i x_i (x_i . u): ``(*B, n, p)``."""
    w = problem.point_hess_weight(theta, X, y)          # (*B, n)
    xu = _xdot(X, u)                                     # (*B, n)
    hi_u = (w * xu).unsqueeze(-1) * X                    # (*B, n, p)
    return hi_u @ hinv.mT


def newton_dir_variance(problem: MEstimationProblem, theta: torch.Tensor,
                        X: torch.Tensor, y: torch.Tensor,
                        g_cq: torch.Tensor,
                        ridge: float = 1e-9) -> torch.Tensor:
    """Eq. (4.10): per-coordinate variance of sqrt(n) h_jl^(1) (w/o noise),
    via identity (4.9): Var_l = Var_i[(H0^{-1} hess_i H0^{-1} g_cq)_l]."""
    p = X.shape[-1]
    h0 = problem.hessian(theta, X, y) + ridge * _eye(p, X)
    # repro-torch: allow(step-sync) — step sync kept: linalg.inv checks its
    # info flag on the host (the card reports it)
    hinv = torch.linalg.inv(h0)
    u = (hinv @ g_cq.unsqueeze(-1)).squeeze(-1)          # (*B, p)
    t = _hinv_hess_rows(problem, theta, X, y, u, hinv)
    return t.var(dim=-2, correction=0)


def bfgs_dir_variance(problem: MEstimationProblem, theta: torch.Tensor,
                      X: torch.Tensor, y: torch.Tensor, v: VOp,
                      g_os: torch.Tensor,
                      ridge: float = 1e-9) -> torch.Tensor:
    """Eq. (4.16): per-coordinate variance of sqrt(n) h_jl^(3) (w/o noise):
    Var_l = Var_i[(V^T H0^{-1} hess_i H0^{-1} V g_os)_l], V applied in
    O(p) through ``v``."""
    p = X.shape[-1]
    h0 = problem.hessian(theta, X, y) + ridge * _eye(p, X)
    # repro-torch: allow(step-sync) — step sync kept: linalg.inv checks its
    # info flag on the host (the card reports it)
    hinv = torch.linalg.inv(h0)
    u = (hinv @ v(g_os, transpose=False).unsqueeze(-1)).squeeze(-1)
    t = _hinv_hess_rows(problem, theta, X, y, u, hinv)
    t = v.rows()(t, transpose=True)
    return t.var(dim=-2, correction=0)
