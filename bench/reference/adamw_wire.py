"""Training with the paper's wire on the gradients, plain: each machine's
gradient, the attack, the Gaussian mechanism, the robust aggregation of
every coordinate over the machines, and AdamW.

Per leaf, in the wire's order (paths sorted): the Byzantine machines'
rows are negated, then ``sigma_leaf * z`` is added to every row (z
standard normals drawn in the storage dtype from the step's key, leaf
after leaf), then each coordinate is aggregated over the machines
(``agg.dcq_mad``). AdamW (float32 moments) clips the aggregated gradient
to global norm ``clip``, then

    mu = b1 mu + (1 - b1) g;  nu = b2 nu + (1 - b2) g^2
    u  = -lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

and adds ``u``, rounded to the storage dtype, to the parameter.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from bench.reference import agg
from bench.reference.glm4 import loss_and_grads
from bench.reference.qn_step import ALTERED, fault_sigmas

F32 = torch.float32


class AdamWReference:
    def __init__(self, cfg: Dict, opt: Dict, sigmas: Dict[str, float],
                 byzantine, machines: int, key: torch.Generator, K: int,
                 lowp: Optional[str] = None, fault: Optional[str] = None):
        """``lowp="fp8"``: the control's model; ``fault``: "half",
        "alter", "nonoise" or "sigma2", as ``qn_step.QNReference`` plants
        them."""
        self.fault = fault
        self.cfg, self.opt = cfg, opt
        self.sigmas = fault_sigmas(sigmas, fault)
        self.byz, self.m, self.key, self.K, self.lowp = (
            list(byzantine), machines, key, K, lowp)
        self.mu, self.nu, self.t = None, None, 0

    def step(self, params: Dict[str, torch.Tensor], batch) -> Dict:
        """One step over ``batch`` (tokens and labels ``(m, rows, S)``);
        ``params`` is updated in place. Returns ``{"loss", "grad"}``,
        ``grad`` the aggregated gradient after the clip, as AdamW takes
        it, as norms per leaf."""
        stack = {k: torch.empty((self.m,) + tuple(v.shape), dtype=v.dtype,
                                device=v.device) for k, v in params.items()}
        losses = []
        for j in range(self.m):
            loss, g = loss_and_grads(params, batch["tokens"][j],
                                     batch["labels"][j], self.cfg, self.lowp,
                                     half=self.fault == "half")
            losses.append(loss)
            for k, v in g.items():
                stack[k][j].copy_(v)
            del g
        red = {}
        for k in sorted(stack):
            v = agg.signflip(stack.pop(k), self.byz)
            z = torch.randn(v.shape, generator=self.key, dtype=v.dtype,
                            device=v.device)
            v = z.mul_(self.sigmas[k]).add_(v)
            red[k] = agg.dcq_mad(v, self.K).to(v.dtype)
            if self.fault == "alter" and k == ALTERED:
                red[k] = red[k] * 2
            del v
        o = self.opt
        if self.mu is None:
            self.mu = {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                       for k, v in params.items()}
            self.nu = {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                       for k, v in params.items()}
        self.t += 1
        gnorm = torch.sqrt(sum(r.to(F32).square().sum() for r in red.values()))
        scale = torch.clamp(o["grad_clip"] / (gnorm + 1e-9), max=1.0)
        bc1 = 1.0 - o["b1"] ** self.t
        bc2 = 1.0 - o["b2"] ** self.t
        grads = {}
        for k in sorted(red):
            g = red.pop(k).to(F32) * scale
            self.mu[k].mul_(o["b1"]).add_(g, alpha=1 - o["b1"])
            self.nu[k].mul_(o["b2"]).addcmul_(g, g, value=1 - o["b2"])
            u = -o["lr"] * (self.mu[k] / bc1) / (
                torch.sqrt(self.nu[k] / bc2) + o["eps"])
            params[k].add_(u.to(params[k].dtype))
            grads[k] = float(torch.linalg.vector_norm(g))
            del u, g
        return {"loss": float(torch.stack(losses).mean()), "grad": grads}
