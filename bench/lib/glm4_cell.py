"""What the two glm4 training cells share: the program's model built from
the configuration file with the benchmark's own weights, set-up that
drives the cell's step through its first steps, the closed-loop window,
the plain reference over the same weights, batches, key and sigmas, and
the numbers that compare the two.

A driver subclasses :class:`Glm4Cell` with four hooks: ``make_step()``
(the program's step and its state), ``program_grad()`` (the first
gradient as the optimizer got it, read from its state after step 1),
``reference(key, lowp, fault)`` (the plain step) and ``reference_grad(out)``
(the same reading from the plain step's first output), and states
``transmissions``, the aggregations of every leaf a step makes.

The readings of a side (the program's, the reference's, or the control's)
are ``{"loss": [mean machine loss of each compared step], "grad": {group:
{leaf: norm}}, "change": {leaf: norm}}``: ``grad`` holds the norms of the
first gradient, ``change`` the norm of each leaf's change over the
compared steps (the workload's ``compare_steps``, the first of the
set-up's steps).
"""
from __future__ import annotations

import gc
import math
from typing import Dict, List, Optional

from bench.lib.seeds import derive
from bench.lib.stats import limit_checks, moved_leaves, norm_gaps, worst
from bench.reference.glm4 import leaf_specs, make_params


def weights_seed(seed: int) -> int:
    """The seed of the generator that draws the initial weights."""
    return derive(seed, "weights")


def model_config(c: Dict):
    """The program's ``ModelConfig`` of configuration file ``c``. Fails on
    a departure from the port's dense block that the program cannot run
    (a q/k/v bias, rotary over part of each head)."""
    from repro_torch.configs.base import ModelConfig
    if c.get("attention_bias", False) or \
            c.get("partial_rotary_factor", 1.0) != 1.0:
        raise ValueError("the port's dense block has no q/k/v bias and "
                         "rotates all of each head")
    return ModelConfig(
        name=c["name"], family="dense", n_layers=c["n_layers"],
        d_model=c["d_model"], n_heads=c["n_heads"],
        n_kv_heads=c["n_kv_heads"], d_ff=c["d_ff"], vocab=c["vocab"],
        d_head=c["head_dim"], rope_theta=c["rope_theta"],
        norm_eps=c["norm_eps"], dtype=c["dtype"])


def build_model(c: Dict, seed: int, device, remat: bool):
    """The program's ``Model`` (its parameters allocated on ``device``
    and written with the benchmark's weights), its parameter tree and the
    tree's leaf paths. Fails unless the program's leaves are the
    configuration's."""
    import torch
    from repro_torch.core.transport import leaf_paths, tree_leaves
    from repro_torch.models.model import Model
    model = Model(model_config(c), device="meta", remat=remat)
    model = model.to_empty(device=torch.device(device))
    params = model.params()
    paths = leaf_paths(params)
    want = [(p, s) for p, s, _ in leaf_specs(c)]
    got = [(p, tuple(x.shape)) for p, x in zip(paths, tree_leaves(params))]
    if got != want:
        raise RuntimeError(f"the program's leaves {got} are not the "
                           f"configuration's {want}")
    init = make_params(c, weights_seed(seed), device)
    with torch.no_grad():
        for p, leaf in zip(paths, tree_leaves(params)):
            leaf.copy_(init[p])
    del init
    return model, params, paths


def norm(x) -> float:
    import torch
    return float(torch.linalg.vector_norm(x.detach().reshape(-1).float()))


def change_norms(c: Dict, seed: int, current: Dict, device) -> Dict:
    """``{leaf: ||current - initial||}``, the initial weights made again."""
    init = make_params(c, weights_seed(seed), device)
    out = {p: norm(current[p].float() - x0.float())
           for p, x0 in init.items()}
    del init
    return out


def batches_for(seed: int, purpose: str, count: int, rows: int, seq: int,
                vocab: int, device) -> List[Dict]:
    """``count`` batches ``{"tokens", "labels"}`` (rows, seq) int64: uniform
    ids over the vocabulary and their shift by one, batch i drawn on
    ``device`` from the generator of ``(seed, "tokens", (purpose, i))``."""
    import torch
    out = []
    for i in range(count):
        g = torch.Generator(device=device).manual_seed(
            derive(seed, "tokens", (purpose, i)))
        ids = torch.randint(0, vocab, (rows, seq + 1), generator=g,
                            device=device)
        out.append({"tokens": ids[:, :-1].contiguous(),
                    "labels": ids[:, 1:].contiguous()})
    return out


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers that decide ``correct``: the loss's largest relative
    gap over the compared steps; the first gradient's worst leaf (each
    group of norms against its own median leaf); the change's worst leaf,
    over the leaves that the reference's first gradient moves (at least a
    thousandth of the median leaf's)."""
    loss = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(prog["loss"], ref["loss"]))
    grad = max(worst(norm_gaps(prog["grad"][g], ref["grad"][g]))
               for g in ref["grad"])
    first = ref["grad"][sorted(ref["grad"])[0]]
    keep = moved_leaves(first)
    change = worst(norm_gaps(prog["change"], ref["change"], keep))
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}


class Glm4Cell:
    """One glm4 training cell: ``setup()``, ``step()``, ``close()``,
    ``check()``, ``b1_launches()``, and for the limits' readings
    ``numbers()`` and ``control_numbers(fault=None)``."""

    #: aggregations of every leaf a step makes (the subclass states it)
    transmissions = 1

    def __init__(self, ctx):
        self.ctx = ctx
        w, c = ctx.workload, ctx.config
        self.m = w["machines"]
        self.rows = w["machines"] * w["rows_per_machine"]
        self.seq = w["seq"]
        self.tokens_per_step = self.rows * self.seq
        self.n_params = c["n_params"]
        self.readings: Optional[Dict] = None
        self.ref_readings: Optional[Dict] = None

    # ------------------------------------------------------------ hooks
    def make_step(self):
        """Set ``self.step_fn`` and its initial ``self.state``."""
        raise NotImplementedError

    def program_grad(self) -> Dict:
        raise NotImplementedError

    def reference(self, key, lowp: Optional[str], fault: Optional[str]):
        raise NotImplementedError

    def reference_grad(self, out: Dict) -> Dict:
        raise NotImplementedError

    # ---------------------------------------------------------- program
    def _key(self):
        import torch
        return torch.Generator(device=self.ctx.device).manual_seed(
            derive(self.ctx.seed, "wire"))

    def _batches(self, purpose: str, count: int) -> List[Dict]:
        return batches_for(self.ctx.seed, purpose, count, self.rows,
                           self.seq, self.ctx.config["vocab"],
                           self.ctx.device)

    def setup(self):
        """Build the model with the benchmark's weights and the step, and
        drive that same step through the workload's ``setup_steps`` steps
        on batches that all differ, keeping the readings of the first
        ``compare_steps``; then draw the window's batches."""
        import torch
        ctx, w, c = self.ctx, self.ctx.workload, self.ctx.config
        self.model, self.params, self.paths = build_model(
            c, ctx.seed, ctx.device, remat=w["remat"])
        self.make_step()
        self.key = self._key()
        self.mask = torch.zeros(self.m, dtype=torch.bool, device=ctx.device)
        self.mask[w["byzantine"]] = True
        losses, grad, change = [], None, None
        for t, batch in enumerate(self._batches("setup", w["setup_steps"])):
            self.params, self.state, met = self.step_fn(
                self.params, self.state, batch, self.key, self.mask)
            losses.append(float(met["loss"]))
            if t == 0:
                grad = self.program_grad()
            if t + 1 == w["compare_steps"]:
                current = dict(zip(self.paths, self._leaves(self.params)))
                change = change_norms(c, ctx.seed, current, ctx.device)
        self.readings = {"loss": losses[:w["compare_steps"]], "grad": grad,
                         "change": change}
        self.window = self._batches("window", w["window_batches"])
        self.i = 0

    @staticmethod
    def _leaves(tree):
        from repro_torch.core.transport import tree_leaves
        return tree_leaves(tree)

    def step(self) -> Dict:
        import torch
        batch = self.window[self.i % len(self.window)]
        self.i += 1
        self.params, self.state, met = self.step_fn(
            self.params, self.state, batch, self.key, self.mask)
        loss = float(met["loss"])
        if self.ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        return {"tokens": self.tokens_per_step, "ok": math.isfinite(loss)}

    def b1_launches(self):
        """Per step, ``transmissions`` aggregations of every leaf,
        (1, m, d_leaf) in the wire's bf16."""
        return [(1, self.m, math.prod(shape), 2, self.transmissions)
                for _, shape, _ in leaf_specs(self.ctx.config)]

    def close(self):
        for name in ("model", "params", "state", "step_fn", "window"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()

    # -------------------------------------------------------- reference
    def reference_readings(self, lowp: Optional[str] = None,
                           fault: Optional[str] = None) -> Dict:
        """The plain step's readings over the same weights, batches, key
        and sigmas (``lowp="fp8"``: the control; ``fault``: a fault
        planted in it)."""
        ctx, w, c = self.ctx, self.ctx.workload, self.ctx.config
        params = make_params(c, weights_seed(ctx.seed), ctx.device)
        ref = self.reference(self._key(), lowp, fault)
        losses, grad = [], None
        for t, batch in enumerate(self._batches("setup", w["compare_steps"])):
            split = {k: v.reshape(self.m, -1, self.seq)
                     for k, v in batch.items()}
            out = ref.step(params, split)
            losses.append(out["loss"])
            if t == 0:
                grad = self.reference_grad(out)
            del out
        change = change_norms(c, ctx.seed, params, ctx.device)
        del ref, params
        gc.collect()
        return {"loss": losses, "grad": grad, "change": change}

    def numbers(self) -> Dict[str, float]:
        self.ref_readings = self.reference_readings()
        return compare(self.readings, self.ref_readings)

    def control_numbers(self, fault: Optional[str] = None
                        ) -> Dict[str, float]:
        """The control in the program's place, against the reference: the
        reference with its matrix products in fp8, or with ``fault``
        planted. Needs no run of the program; the reference's readings
        are made once for every control and fault of the cell."""
        low = self.reference_readings(None if fault else "fp8", fault)
        if self.ref_readings is None:
            self.ref_readings = self.reference_readings()
        return compare(low, self.ref_readings)

    def check(self):
        return limit_checks(self.numbers(), self.ctx.workload["limits"])
