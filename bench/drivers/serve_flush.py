"""The federated operator's flush: ``repro_torch.serve.AggregationService``
with a ring of ``capacity`` machines, fed one full round of updates at a
time through ``submit_many`` (the capacity flush fires inside it), rounds
back to back with one in flight.

Set-up builds the service and draws ``rounds`` rounds of updates on the
card from the seed (cycled through in the window), then serves
``warm_rounds`` rounds. The window serves rounds until it closes and
times each from its ``submit_many`` call to the synchronise that ends its
flush; for a sample of rounds drawn from the seed it copies theta before
and after the round on the card, without a host read. The check works
out each sampled round again with the plain reference
(``bench.reference.serve_flush``) from the same updates and the round's
noise stream, and compares the move of theta with the program's.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

from bench.lib.dp import sigma
from bench.lib.seeds import derive
from bench.lib.stats import limit_checks


def build(ctx):
    return ServeCell(ctx)


class ServeCell:
    def __init__(self, ctx):
        self.ctx = ctx
        w = ctx.workload
        self.cap, self.p = w["capacity"], ctx.config["p"]
        self.service_seed = derive(ctx.seed, "serve")
        self.samples: List = []

    def setup(self):
        import torch
        from repro_torch.serve.service import AggregationService, ServeConfig
        w, dev = self.ctx.workload, self.ctx.device
        g = torch.Generator(device=dev).manual_seed(
            derive(self.ctx.seed, "updates"))
        centre = torch.randn((w["rounds"], 1, self.p), generator=g,
                             device=dev)
        self.updates = centre + w["spread"] * torch.randn(
            (w["rounds"], self.cap, self.p), generator=g, device=dev)
        theta0 = torch.randn(self.p, generator=g, device=dev)
        self.svc = AggregationService(theta0, ServeConfig(
            method=w["method"], capacity=self.cap, eps=w["eps"],
            delta=w["delta"], dp_n=w["dp_n"], dp_gamma=w["dp_gamma"],
            lr=w["lr"], K=w["K"], ingest_block=w["ingest_block"],
            seed=self.service_seed), device=dev)
        for _ in range(w["warm_rounds"]):
            self._round()

    def _round(self):
        r = self.svc.round_idx
        self.svc.submit_many(self.updates[r % len(self.updates)])
        if self.svc.round_idx != r + 1:
            raise RuntimeError("a full round did not flush")

    def _sampled(self, r: int) -> bool:
        return derive(self.ctx.seed, "sample", r) % \
            self.ctx.workload["sample_every"] == 0

    def step(self) -> Dict:
        r = self.svc.round_idx
        keep = self._sampled(r) or not self.samples
        before = self.svc.theta.clone() if keep else None
        t0 = time.perf_counter()
        self._round()
        dt = time.perf_counter() - t0
        if keep:
            self.samples.append((r, before, self.svc.theta.clone()))
        return {"updates": self.cap, "round_s": dt}

    def b1_launches(self):
        """One dcq_mad aggregation of (1, capacity, p) f32 values a
        round."""
        return [(1, self.cap, self.p, 4, 1)]

    def close(self):
        del self.svc

    def _moves(self, dtype, fault=None):
        from bench.reference.serve_flush import round_step
        w = self.ctx.workload
        s = sigma(self.p, w["dp_n"], w["dp_gamma"], w["eps"], w["delta"])
        for r, before, after in self.samples:
            move, scale = round_step(self.updates[r % len(self.updates)],
                                     self.service_seed, r, s, w["lr"],
                                     w["K"], dtype, fault)
            yield (after.double() - before.double(), move.double(),
                   w["lr"] * scale.double())

    @staticmethod
    def _worst(pairs) -> float:
        """The largest of ``|got - ref| / unit`` over the rounds and the
        coordinates; a value that is not finite reads as infinite."""
        import torch
        worst = 0.0
        for got, ref, unit in pairs:
            gap = (got - ref).abs() / unit
            if not bool(torch.isfinite(gap).all()):
                return math.inf
            worst = max(worst, float(gap.max()))
        return worst

    def numbers(self) -> Dict[str, float]:
        """The largest gap, over the sampled rounds and the coordinates,
        between the program's move of theta and the reference's (float64),
        over lr times the round's MAD scale."""
        import torch
        return {"update_gap": self._worst(self._moves(torch.float64))}

    def control_numbers(self, fault=None) -> Dict[str, float]:
        """The control in the program's place: the reference's round in
        bfloat16 (or in float64 with ``fault`` planted), against the
        reference's in float64."""
        import torch
        low = self._moves(torch.float64 if fault else torch.bfloat16, fault)
        return {"update_gap": self._worst(
            (lo, ref, unit) for (_, lo, _), (_, ref, unit)
            in zip(low, self._moves(torch.float64)))}

    def check(self):
        return limit_checks(self.numbers(), self.ctx.workload["limits"])
