"""BFGS machinery (paper §4.1 and eq. 4.13) and the L-BFGS two-loop —
``repro/core/bfgs.py`` counterpart.

The protocol's second iteration updates every machine's inverse Hessian by

    H^+ = V^T H V + rho * s s^T,      V = I - rho * y s^T,
    rho = 1 / (s^T y),   s = theta_os - theta_cq,   y = g_diff,

and only ever needs products with V, so ``VOp`` applies V in O(p) and the
center never forms a p x p matrix. ``s``, ``y`` and ``rho`` of a ``VOp``
may carry leading batch dimensions (Monte-Carlo replicates); ``x``
broadcasts against them. The dense p x p inverse stays with the convex
head (``bfgs_inverse_update``).

At model scale the curvature state is an ``LBFGSMemory`` of ``hist``
(s, y) pairs, leaves shaped ``(hist, *leaf)`` (with a leading machine axis
for per-machine memories): 2 * hist parameter copies instead of p^2
floats. ``lbfgs_two_loop_tree`` applies the implied inverse Hessian with
tree-wide inner products in the leaves' own dtype; the flat form is its
single-leaf case. Empty slots are masked by ``arange(hist) >= max(hist -
count, 0)``, as the reference masks them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch import obs
from repro_torch.core.transport import tree_dot, tree_leaves, tree_map


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


def bfgs_inverse_update(h_inv: torch.Tensor, s: torch.Tensor,
                        y: torch.Tensor) -> torch.Tensor:
    """Dense BFGS inverse update (eq. 4.13) on the p x p convex head:
    V^T H V by two rank-1 applications, O(p^2)."""
    v = make_v(s, y)
    rho = v.rho
    hv = h_inv - torch.outer(h_inv @ v.y, v.s) * rho          # H V
    vthv = hv - torch.outer(v.s, v.y @ hv) * rho              # V^T (H V)
    return vthv + rho * torch.outer(s, s)


def bfgs_dir_product(h_inv_apply: Callable[[torch.Tensor], torch.Tensor],
                     v: VOp, g: torch.Tensor,
                     rho_term: bool = True) -> torch.Tensor:
    """h = V^T H^{-1} V g (+ rho s s^T g): the machine-side product in
    (4.15) plus the center-side rank-1 term. ``h_inv_apply`` is any linear
    operator (a dense solve on the convex head, the two-loop at scale)."""
    out = v(g, transpose=False)
    out = h_inv_apply(out)
    out = v(out, transpose=True)
    if rho_term:
        out = out + (v.rho.unsqueeze(-1) * v.s
                     * _dot(v.s, g).unsqueeze(-1))
    return out


# ------------------------------------------------------------- L-BFGS

@dataclasses.dataclass
class LBFGSMemory:
    """Fixed-size (s, y) history for two-loop products.

    ``s_hist``/``y_hist`` are flat ``(hist, p)`` tensors (the single-leaf
    case) or trees of ``(hist, *leaf)`` tensors; with a leading machine
    axis ``(m, hist, *leaf)`` and ``count (m,)`` they hold one memory per
    machine (:meth:`machine` is machine j's, as views). ``count`` is an
    int32 tensor: the pairs pushed so far."""
    s_hist: Any
    y_hist: Any
    count: torch.Tensor

    @staticmethod
    def init(hist: int, p: int, dtype=torch.float32,
             device=None) -> "LBFGSMemory":
        def zeros():
            return torch.zeros((hist, p), dtype=dtype, device=device)
        return LBFGSMemory(zeros(), zeros(),
                           torch.zeros((), dtype=torch.int32, device=device))

    @staticmethod
    def init_like(hist: int, tree: Any,
                  machines: Optional[int] = None) -> "LBFGSMemory":
        """Zeroed history shaped after ``tree``; with ``machines=m`` the
        leaves get a leading machine axis ``(m, hist, *leaf)`` and
        ``count`` becomes ``(m,)``."""
        lead = (machines, hist) if machines else (hist,)

        def zeros(p):
            return torch.zeros(lead + tuple(p.shape), dtype=p.dtype,
                               device=p.device)
        dev = tree_leaves(tree)[0].device
        count = torch.zeros((machines,) if machines else (),
                            dtype=torch.int32, device=dev)
        return LBFGSMemory(tree_map(zeros, tree), tree_map(zeros, tree),
                           count)

    def push(self, s: Any, y: Any) -> "LBFGSMemory":
        """A new memory: every history rolled one slot toward the front,
        ``(s, y)`` written into the last slot, ``count + 1``."""
        new = self.clone()
        for hist, v in zip(tree_leaves(new.s_hist) + tree_leaves(new.y_hist),
                           tree_leaves(s) + tree_leaves(y)):
            push_leaf_(hist, v)
        new.count += 1
        return new

    def machine(self, j: int) -> "LBFGSMemory":
        """Machine j's memory of a per-machine one, as views."""
        return LBFGSMemory(tree_map(lambda h: h[j], self.s_hist),
                           tree_map(lambda h: h[j], self.y_hist),
                           self.count[j])

    def clone(self) -> "LBFGSMemory":
        return LBFGSMemory(tree_map(torch.clone, self.s_hist),
                           tree_map(torch.clone, self.y_hist),
                           self.count.clone())


def push_leaf_(hist: torch.Tensor, v: torch.Tensor) -> None:
    """Push ``v`` into one ``(hist, *leaf)`` history leaf in place: a roll
    one slot toward the front, then ``v`` (cast to the history's dtype) in
    the last slot, without a second copy of the history."""
    for k in range(hist.shape[0] - 1):
        hist[k].copy_(hist[k + 1])
    hist[-1].copy_(v)


def _valid(hist: int, count: torch.Tensor) -> torch.Tensor:
    return (torch.arange(hist, device=count.device)
            >= torch.clamp_min(hist - count, 0))


def _rho(s: Any, y: Any, ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, 1.0 / torch.clamp_min(tree_dot(s, y), 1e-12),
                       0.0)


def two_loop_(mem: LBFGSMemory, q: Any, gamma=1.0) -> Any:
    """The two-loop recursion on the tree ``q`` IN PLACE (its leaves end
    up holding the direction; returns ``q``). ``mem`` is one machine's
    memory, leaves ``(hist, *leaf)``. Sums and scalars are in the leaves'
    dtype; nothing waits for the device."""
    s_leaves, y_leaves = tree_leaves(mem.s_hist), tree_leaves(mem.y_hist)
    q_leaves = tree_leaves(q)
    hist = s_leaves[0].shape[0]
    with obs.span("repro.lbfgs"):
        valid = _valid(hist, mem.count)
        alphas = [None] * hist
        for i in reversed(range(hist)):
            s = [h[i] for h in s_leaves]
            y = [h[i] for h in y_leaves]
            a = _rho(s, y, valid[i]) * tree_dot(s, q_leaves)
            coef = torch.where(valid[i], a, 0.0)
            for qq, yy in zip(q_leaves, y):
                qq.sub_(coef * yy)
            alphas[i] = a
        for qq in q_leaves:
            qq.mul_(gamma)
        for i in range(hist):
            s = [h[i] for h in s_leaves]
            y = [h[i] for h in y_leaves]
            b = _rho(s, y, valid[i]) * tree_dot(y, q_leaves)
            coef = torch.where(valid[i], alphas[i] - b, 0.0)
            for rr, ss in zip(q_leaves, s):
                rr.add_(coef * ss)
    return q


def lbfgs_two_loop_tree(mem: LBFGSMemory, g: Any, gamma=1.0) -> Any:
    """Two-loop recursion over a gradient tree (a new tree); empty slots
    are masked out. Curvatures are tree-wide inner products, so on one
    flat leaf this is exactly :func:`lbfgs_two_loop`."""
    return two_loop_(mem, tree_map(torch.clone, g), gamma)


def lbfgs_two_loop(mem: LBFGSMemory, g: torch.Tensor,
                   gamma=1.0) -> torch.Tensor:
    """The standard two-loop recursion on flat ``(hist, p)`` histories."""
    return lbfgs_two_loop_tree(mem, g, gamma)


def lbfgs_gamma(mem: LBFGSMemory) -> torch.Tensor:
    """Barzilai–Borwein initial scaling gamma = s.y / y.y of the most
    recent pair (the dots in the leaves' dtype), as f32; 1.0 while the
    memory is empty."""
    s_last = [h[-1] for h in tree_leaves(mem.s_hist)]
    y_last = [h[-1] for h in tree_leaves(mem.y_hist)]
    with obs.span("repro.lbfgs"):
        sy = tree_dot(s_last, y_last)
        yy = tree_dot(y_last, y_last)
        return torch.where(mem.count > 0, sy / torch.clamp_min(yy, 1e-12),
                           1.0).to(torch.float32)
