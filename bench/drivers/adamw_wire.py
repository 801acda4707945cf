"""Training with the paper's wire on the gradients: the step behind
``repro_torch.train.trainer.Trainer`` (``make_train_step``: per-machine
gradients, the attack, per-leaf calibrated DP noise, one robust
aggregation of every leaf, AdamW), called back to back.

The state is AdamW's. The first gradient is the aggregated gradient as
AdamW took it: its first moment after one step over ``1 - b1``. The
plain side is ``bench.reference.adamw_wire``.
"""
from __future__ import annotations

from typing import Dict

from bench.lib import glm4_cell as G


def build(ctx):
    return AdamWWireCell(ctx)


class AdamWWireCell(G.Glm4Cell):
    transmissions = 1

    def make_step(self):
        from repro_torch.dist.grad_agg import GradAggConfig
        from repro_torch.train.optimizer import AdamW
        from repro_torch.train.trainer import TrainConfig, make_train_step
        w = self.ctx.workload
        o, dp = w["optimizer"], w["dp"]
        agg = GradAggConfig(method=w["aggregator"], attack=w["attack"],
                            K=w["K"], dp_eps=dp["eps"], dp_delta=dp["delta"],
                            dp_gamma=dp["gamma"], dp_n=dp["n"])
        opt = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"], grad_clip=o["grad_clip"])
        self.step_fn = make_train_step(self.model, opt, TrainConfig(
            n_machines=self.m, remat=w["remat"], agg=agg))
        self.state = opt.init(self.params)

    def program_grad(self) -> Dict:
        b1 = self.ctx.workload["optimizer"]["b1"]
        return {"g": {p: G.norm(mu) / (1 - b1) for p, mu in
                      zip(self.paths, self._leaves(self.state.mu))}}

    def reference(self, key, lowp, fault):
        from bench.reference.adamw_wire import AdamWReference
        w = self.ctx.workload
        return AdamWReference(self.ctx.config, w["optimizer"],
                              w["dp"]["sigmas"], w["byzantine"], self.m, key,
                              w["K"], lowp=lowp, fault=fault)

    def reference_grad(self, out: Dict) -> Dict:
        return {"g": out["grad"]}
