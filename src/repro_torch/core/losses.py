"""Convex M-estimation losses (paper eq. 1.1; experiments §5) —
``repro/core/losses.py`` counterpart.

Each problem exposes mean loss / gradient / Hessian over a data shard plus
the per-sample quantities the protocol's variance estimators need
(Lemma 4.2, eqs. 4.10/4.16). Closed forms, as in the reference.

Data convention: ``X`` is ``(*Bx, n, p)``, ``y`` is ``(*Bx, n)`` and theta
is ``(*Bt, p)``, where the leading batch shapes broadcast against each
other. That is the reference's ``vmap`` over machines (and over Monte-Carlo
replicates) written out: ``X`` of shape ``(m+1, n, p)`` with ``theta`` of
shape ``(R, 1, p)`` gives one result per replicate and machine.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F


def _xdot(X: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """``X @ theta`` per sample, broadcasting the leading batch shapes:
    ``(*Bx, n, p), (*Bt, p) -> (*B, n)``."""
    return (X @ theta.unsqueeze(-1)).squeeze(-1)


class MEstimationProblem:
    name: str = "base"

    # -- per-sample primitives -------------------------------------------
    def point_loss(self, theta, X, y):
        raise NotImplementedError

    def point_grad(self, theta, X, y):
        raise NotImplementedError

    def point_hess_weight(self, theta, X, y):
        """``w(x, y, theta)`` per sample, with hess = w * x x^T."""
        raise NotImplementedError

    # -- shard-level reductions ------------------------------------------
    def loss(self, theta, X, y):
        return self.point_loss(theta, X, y).mean(dim=-1)

    def grad(self, theta, X, y):
        """``(*B, p)`` mean gradient nabla F_j(theta)."""
        return self.per_sample_grads(theta, X, y).mean(dim=-2)

    def per_sample_grads(self, theta, X, y):
        """``(*B, n, p)`` per-sample gradients nabla f(X_i, theta)."""
        return self.point_grad(theta, X, y)

    def hessian(self, theta, X, y):
        """``(*B, p, p)`` mean Hessian nabla^2 F_j(theta)."""
        w = self.point_hess_weight(theta, X, y)            # (*B, n)
        return (X * w.unsqueeze(-1)).mT @ X / X.shape[-2]

    def grad_variance(self, theta, X, y):
        """``(*B, p)`` per-coordinate variance of nabla f_l(X_i, theta)
        (population variance, as ``jnp.var``)."""
        return self.per_sample_grads(theta, X, y).var(dim=-2, correction=0)


class LogisticRegression(MEstimationProblem):
    """f(x, y; theta) = log(1+exp(x.theta)) - y x.theta  (Experiment 1)."""
    name = "logistic"

    def point_loss(self, theta, X, y):
        z = _xdot(X, theta)
        return F.softplus(z) - y * z

    def point_grad(self, theta, X, y):
        z = _xdot(X, theta)
        return (torch.sigmoid(z) - y).unsqueeze(-1) * X

    def point_hess_weight(self, theta, X, y):
        s = torch.sigmoid(_xdot(X, theta))
        return s * (1.0 - s)


class PoissonRegression(MEstimationProblem):
    """f = exp(x.theta) - y x.theta  (Experiment 2)."""
    name = "poisson"

    def point_loss(self, theta, X, y):
        z = _xdot(X, theta)
        return torch.exp(z) - y * z

    def point_grad(self, theta, X, y):
        z = _xdot(X, theta)
        return (torch.exp(z) - y).unsqueeze(-1) * X

    def point_hess_weight(self, theta, X, y):
        return torch.exp(_xdot(X, theta))


class LinearRegression(MEstimationProblem):
    """f = 0.5 (y - x.theta)^2."""
    name = "linear"

    def point_loss(self, theta, X, y):
        r = y - _xdot(X, theta)
        return 0.5 * r * r

    def point_grad(self, theta, X, y):
        return -(y - _xdot(X, theta)).unsqueeze(-1) * X

    def point_hess_weight(self, theta, X, y):
        # shaped by the broadcast of theta against X, like the other rules
        return torch.ones_like(_xdot(X, theta))


class HuberRegression(MEstimationProblem):
    """Huber loss with threshold c (robust location-scale regression)."""
    name = "huber"

    def __init__(self, c: float = 1.345):
        self.c = c

    def point_loss(self, theta, X, y):
        r = y - _xdot(X, theta)
        a = r.abs()
        return torch.where(a <= self.c, 0.5 * r * r,
                           self.c * a - 0.5 * self.c ** 2)

    def point_grad(self, theta, X, y):
        r = y - _xdot(X, theta)
        psi = r.clamp(-self.c, self.c)
        return -psi.unsqueeze(-1) * X

    def point_hess_weight(self, theta, X, y):
        r = y - _xdot(X, theta)
        return (r.abs() <= self.c).to(X.dtype)


PROBLEMS: Dict[str, Callable[[], MEstimationProblem]] = {
    "logistic": LogisticRegression,
    "poisson": PoissonRegression,
    "linear": LinearRegression,
    "huber": HuberRegression,
}


def get_problem(name: str) -> MEstimationProblem:
    return PROBLEMS[name]()
