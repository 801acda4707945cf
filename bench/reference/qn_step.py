"""The quasi-Newton protocol step over a parameter tree, plain: Algorithm
1's five noised, corrupted and robustly aggregated transmissions with a
per-machine L-BFGS memory, as one training step.

    R1  theta_j = theta - local_lr * grad_j(theta)       -> agg -> theta_cq
    R2  grad_j(theta_cq)                                 -> agg -> g_cq
    R3  d_j = H_j g_cq (machine j's L-BFGS two-loop)     -> agg -> H1
        theta_os = theta_cq - lr * H1
    R4  y_j = grad_j(theta_os) - grad_j(theta_cq)        -> agg -> y
        s = theta_os - theta_cq; machine j keeps (s, y_j) where s . y_j
        > 1e-10 (its raw y_j, before noise and corruption)
    R5  d_j = H_j (g_cq + y)                             -> agg -> H2
        theta_qn = theta_os - lr * H2

A transmission adds ``sigma_leaf * z`` to every machine's row of every
leaf (z standard normals drawn in the storage dtype, leaf after leaf, from
the transmission's own generator), negates the Byzantine machines' rows,
and aggregates each coordinate over the machines (``agg.dcq_mad``). The
sixteen generators of a step are seeded, as the protocol states, from
sixteen draws of ``randint(0, 2**62)`` from the step's key; transmission
R1 draws from the first, R2 from the third, R3 the seventh, R4 the ninth
and R5 the eleventh. The two-loop recursion and its scaling gamma = s.y /
y.y of the newest pair are computed in float32 from the stored bf16
pairs. Every tree is kept in the storage dtype between the operations, as
the wire states.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from bench.reference import agg
from bench.reference.glm4 import loss_and_grads

#: each transmission's slot among the step's sixteen generators
NOISE_SLOT = {"R1": 0, "R2": 2, "R3": 6, "R4": 8, "R5": 10}
#: the leaf whose aggregate the "alter" fault doubles
ALTERED = "layers/attn/w_k"
F32 = torch.float32


def fault_sigmas(sigmas: Dict[str, float], fault: Optional[str]
                 ) -> Dict[str, float]:
    """The sigmas a planted fault leaves: none ("nonoise"), each doubled
    ("sigma2"), otherwise as stated."""
    scale = {"nonoise": 0.0, "sigma2": 2.0}.get(fault, 1.0)
    return {k: v * scale for k, v in sigmas.items()}


def split_key(key: torch.Generator) -> List[torch.Generator]:
    seeds = torch.randint(0, 2 ** 62, (16,), generator=key,
                          device=key.device).tolist()
    return [torch.Generator(device=key.device).manual_seed(s) for s in seeds]


def _dot(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    return sum(torch.dot(a[k].reshape(-1).to(F32),
                         b[k].reshape(-1).to(F32)).double() for k in a)


class Memory:
    """One machine's L-BFGS pairs, oldest first, at most ``hist``."""

    def __init__(self, hist: int):
        self.hist, self.pairs = hist, []

    def push(self, s, y):
        self.pairs = (self.pairs + [(s, y)])[-self.hist:]

    def direction(self, g: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """H g by the two-loop recursion, in float32, rounded to g's
        dtype."""
        q = {k: v.to(F32, copy=True) for k, v in g.items()}
        rhos = [1.0 / torch.clamp_min(_dot(s, y), 1e-12)
                for s, y in self.pairs]
        alphas = []
        for (s, y), rho in zip(reversed(self.pairs), reversed(rhos)):
            a = (rho * _dot(s, q)).float()
            for k in q:
                q[k].sub_(a * y[k].to(F32))
            alphas.append(a)
        alphas.reverse()
        if self.pairs:
            s, y = self.pairs[-1]
            gamma = (_dot(s, y) / torch.clamp_min(_dot(y, y), 1e-12)).float()
            for k in q:
                q[k].mul_(gamma)
        for (s, y), rho, a in zip(self.pairs, rhos, alphas):
            b = (rho * _dot(y, q)).float()
            for k in q:
                q[k].add_((a - b) * s[k].to(F32))
        return {k: v.to(g[k].dtype) for k, v in q.items()}


def _storage_axpy(x: torch.Tensor, c: float, y: torch.Tensor):
    """``x + c * y`` with ``c * y`` rounded to the storage dtype first."""
    return x + (y * c)


class QNReference:
    """The plain step over ``params`` (path -> tensor, updated in place).

    ``cfg``: the model configuration; ``proto``: lr, local_lr,
    local_steps, hist, K; ``sigmas``: path -> sigma of every
    transmission's noise (0 for none); ``byzantine``: the signflipped
    machines; ``lowp``: None, or "fp8" for the control's model.
    ``fault`` plants one of the faults the check must catch, with the
    reference in the program's place: "half" (each machine's loss over
    half its positions), "alter" (the aggregated gradient of the first
    leaf after the embedding doubled), "nonoise" (every sigma 0), "sigma2"
    (every sigma doubled)."""

    def __init__(self, cfg: Dict, proto: Dict, sigmas: Dict[str, float],
                 byzantine, machines: int, key: torch.Generator,
                 lowp: Optional[str] = None, fault: Optional[str] = None):
        self.cfg, self.proto = cfg, proto
        self.sigmas = fault_sigmas(sigmas, fault)
        self.byz, self.m, self.key, self.lowp = (list(byzantine), machines,
                                                 key, lowp)
        self.fault = fault
        self.mems = [Memory(proto["hist"]) for _ in range(machines)]

    def _grad(self, params, batch, j):
        return loss_and_grads(params, batch["tokens"][j],
                              batch["labels"][j], self.cfg, self.lowp,
                              half=self.fault == "half")

    def _tx(self, gens, slot, stack, post=None):
        out = {}
        for k in sorted(stack):
            v = stack.pop(k)
            z = torch.randn(v.shape, generator=gens[NOISE_SLOT[slot]],
                            dtype=v.dtype, device=v.device)
            v = z.mul_(self.sigmas[k]).add_(v)
            agg.signflip(v, self.byz)
            red = agg.dcq_mad(v, self.proto["K"]).to(v.dtype)
            if self.fault == "alter" and slot == "R2" and k == ALTERED:
                red = red * 2
            del v
            out[k] = red if post is None else post(k, red)
        return out

    def _rows(self, like, fill):
        stack = {k: torch.empty((self.m,) + tuple(v.shape), dtype=v.dtype,
                                device=v.device) for k, v in like.items()}
        for j in range(self.m):
            for k, v in fill(j).items():
                stack[k][j].copy_(v)
        return stack

    def step(self, params: Dict[str, torch.Tensor], batch) -> Dict:
        """One protocol step; ``params`` is set to theta_qn. Returns
        ``{"loss": mean machine loss, "s": path -> s, "y": [path -> y_j]}``
        (the pairs this step pushed; None for a machine that kept its
        memory)."""
        p = self.proto
        lr, llr = p["lr"], p["local_lr"]
        gens = split_key(self.key)
        losses = []

        def local(j):
            theta = params
            for step in range(p["local_steps"]):
                loss, g = self._grad(theta, batch, j)
                if step == 0:
                    losses.append(loss)
                theta = {k: _storage_axpy(theta[k], -llr, g[k])
                         for k in g}
            return theta

        theta_cq = self._tx(gens, "R1", self._rows(params, local))

        def grad_cq(j):
            return self._grad(theta_cq, batch, j)[1]
        g_cq = self._tx(gens, "R2", self._rows(params, grad_cq))
        theta_os = self._tx(
            gens, "R3", self._rows(params, lambda j:
                                   self.mems[j].direction(g_cq)),
            post=lambda k, h: _storage_axpy(theta_cq[k], -lr, h))
        s = {k: theta_os[k] - theta_cq[k] for k in params}

        def diff(j):
            g_os = self._grad(theta_os, batch, j)[1]
            g_c = self._grad(theta_cq, batch, j)[1]
            return {k: g_os[k] - g_c[k] for k in g_os}
        stack = self._rows(params, diff)
        pushed = []
        for j in range(self.m):
            y = {k: stack[k][j].clone() for k in stack}
            if float(_dot(s, y)) > 1e-10:
                self.mems[j].push(s, y)
                pushed.append(y)
            else:
                pushed.append(None)
        v_y = self._tx(gens, "R4", stack)
        theta_qn = self._tx(
            gens, "R5", self._rows(params, lambda j: self.mems[j].direction(
                {k: g_cq[k] + v_y[k] for k in g_cq})),
            post=lambda k, h: _storage_axpy(theta_os[k], -lr, h))
        with torch.no_grad():
            for k in params:
                params[k].copy_(theta_qn[k])
        loss = torch.stack(losses).mean()
        return {"loss": float(loss), "s": s, "y": pushed}
