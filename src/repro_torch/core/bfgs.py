"""BFGS machinery of the flat protocol (paper §4.1 and eq. 4.13) —
``repro/core/bfgs.py`` counterpart.

The protocol's second iteration only needs products with

    V = I - rho * y s^T,   rho = 1 / (s^T y),
    s = theta_os - theta_cq,   y = g_diff,

so ``VOp`` applies V in O(p) and no p x p matrix is formed. ``s``, ``y``
and ``rho`` may carry leading batch dimensions (Monte-Carlo replicates);
``x`` broadcasts against them. The L-BFGS memory of the model-scale engine
belongs to a later slice.
"""
from __future__ import annotations

import dataclasses

import torch


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class VOp:
    """V = I - rho * y s^T applied in O(p)."""
    s: torch.Tensor
    y: torch.Tensor
    rho: torch.Tensor

    def __call__(self, x: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
        rho = self.rho.unsqueeze(-1)
        if transpose:   # V^T x = x - rho * s (y . x)
            return x - rho * self.s * _dot(self.y, x).unsqueeze(-1)
        return x - rho * self.y * _dot(self.s, x).unsqueeze(-1)

    def rows(self) -> "VOp":
        """The same operator applied to each row of an ``(*B, k, p)``
        stack (the reference's ``vmap`` over rows)."""
        return VOp(s=self.s.unsqueeze(-2), y=self.y.unsqueeze(-2),
                   rho=self.rho.unsqueeze(-1))


def make_v(s: torch.Tensor, y: torch.Tensor) -> VOp:
    rho = 1.0 / _dot(s, y)
    return VOp(s=s, y=y, rho=rho)
