"""The paper's algorithm as the training step: one five-transmission
protocol step of ``repro_torch.train.trainer.make_qn_train_step`` over the
whole parameter tree, called back to back.

The state is the per-machine L-BFGS memory. The first gradient is read
from it after step 1: ``s`` = theta_os - theta_cq, which is ``-lr``
times the first aggregated gradient direction, and each machine's raw
gradient difference ``y_j``. The plain side is
``bench.reference.qn_step``.
"""
from __future__ import annotations

from typing import Dict

from bench.lib import glm4_cell as G


def build(ctx):
    return QNStepCell(ctx)


class QNStepCell(G.Glm4Cell):
    transmissions = 5

    def make_step(self):
        from repro_torch.configs.base import TreeProtocolConfig
        from repro_torch.core.bfgs import LBFGSMemory
        from repro_torch.train.trainer import (QNTrainConfig,
                                               make_qn_train_step)
        w, c = self.ctx.workload, self.ctx.config
        p, dp = w["protocol"], w["dp"]
        if dp["n"] != w["rows_per_machine"]:
            raise ValueError("the protocol calibrates its noise at n = the "
                             "rows of a machine")
        proto = TreeProtocolConfig(
            hist=c["qn_hist"], lr=p["lr"], local_lr=p["local_lr"],
            local_steps=p["local_steps"], eps=dp["eps"], delta=dp["delta"],
            gammas=(dp["gamma"],) * dp["transmissions"],
            aggregator=p["aggregator"], K=p["K"])
        self.step_fn = make_qn_train_step(self.model, QNTrainConfig(
            n_machines=self.m, attack=w["attack"], protocol=proto,
            remat=w["remat"]))
        self.state = LBFGSMemory.init_like(c["qn_hist"], self.params,
                                           machines=self.m)

    def program_grad(self) -> Dict:
        """``s`` (machine 1's newest slot; every machine that pushed holds
        the same s) and each machine's ``y_j``."""
        s_h = self._leaves(self.state.s_hist)
        y_h = self._leaves(self.state.y_hist)
        out = {"s": {p: G.norm(h[1, -1]) for p, h in zip(self.paths, s_h)}}
        for j in range(self.m):
            out[f"y{j}"] = {p: G.norm(h[j, -1])
                            for p, h in zip(self.paths, y_h)}
        return out

    def reference(self, key, lowp, fault):
        from bench.reference.qn_step import QNReference
        w, c = self.ctx.workload, self.ctx.config
        p = dict(w["protocol"], hist=c["qn_hist"])
        return QNReference(c, p, w["dp"]["sigmas"], w["byzantine"], self.m,
                           key, lowp=lowp, fault=fault)

    def reference_grad(self, out: Dict) -> Dict:
        """The same reading from the plain step's pushed pairs (0 for a
        machine that kept its memory)."""
        res = {"s": {k: G.norm(v) for k, v in out["s"].items()}}
        for j in range(self.m):
            y = out["y"][j]
            res[f"y{j}"] = {k: (G.norm(y[k]) if y is not None else 0.0)
                            for k in out["s"]}
        return res
