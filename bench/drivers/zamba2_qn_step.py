"""The paper's algorithm as the training step of Zamba2 as published: the
QN step of ``qn_step`` (``make_qn_train_step``, read as there) over the
program's ``Zamba2Config`` model, whose weights are the benchmark's own
(``bench.reference.zamba2``). The plain side is
``bench.reference.zamba2.Zamba2QNReference``.

The workload's per-leaf sigmas are its top-level ``sigmas``
(``bench/tools/zamba2_sigmas.py`` writes them), and
``bench/tests/test_bench_zamba2.py`` holds the program's own calibration
to them. Building the cell fails at once, before anything is drawn on the
card, where the program has no ``Zamba2Config``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from bench.drivers.qn_step import QNStepCell
from bench.lib import glm4_cell as G
from bench.reference.zamba2 import (Zamba2QNReference, leaf_dtype,
                                    leaf_specs, make_params)

#: readings of the reference in a lower precision, besides the fp8 control
LOWP = ("bf16scan",)


def build(ctx):
    return Zamba2QNStepCell(ctx)


def program_config(c: Dict):
    """The program's ``Zamba2Config`` of configuration file ``c``. Fails
    where the program has none, or where the file asks for what the
    published block does not have."""
    try:
        from repro_torch.configs.base import SSMConfig, Zamba2Config
    except ImportError as exc:
        raise RuntimeError("the program has no Zamba2Config: it cannot run "
                           "Zamba2 as published") from exc
    kinds = ["hybrid" if i in c["hybrid_layer_ids"] else "mamba"
             for i in range(c["num_hidden_layers"])]
    if kinds != c["layers_block_type"] or c["use_shared_attention_adapter"] \
            or not c["use_shared_mlp_adapter"] or not c["use_mem_rope"] \
            or c["add_bias_linear"] or not c["use_conv_bias"] \
            or c["hidden_act"] != "gelu" or not c["tie_embeddings"] \
            or c["attention_hidden_size"] != 2 * c["hidden_size"]:
        raise ValueError("the file departs from the published block")
    return Zamba2Config(
        name=c["name"], family="hybrid", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab=c["vocab_size"], d_head=c["attention_head_dim"],
        ssm=SSMConfig(d_state=c["mamba_d_state"], n_groups=c["mamba_ngroups"],
                      d_conv=c["mamba_d_conv"], expand=c["mamba_expand"],
                      chunk=c["chunk_size"], headdim=c["mamba_headdim"]),
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=True, hybrid_layers=tuple(c["hybrid_layer_ids"]),
        num_mem_blocks=c["num_mem_blocks"], adapter_rank=c["adapter_rank"],
        dt_min=c["time_step_min"],
        dtype=c["dtype"])


def build_model(c: Dict, cfg, seed: int, device, remat: bool):
    """The program's ``Model`` of ``cfg`` with the benchmark's weights, its
    tree and leaf paths; fails unless its leaves are the file's."""
    import torch
    from repro_torch.core.transport import leaf_paths, tree_leaves
    from repro_torch.models.model import Model
    model = Model(cfg, device="meta", remat=remat)
    model = model.to_empty(device=torch.device(device))
    params = model.params()
    paths = leaf_paths(params)
    want = [(p, s, leaf_dtype(c, p)) for p, s, _ in leaf_specs(c)]
    got = [(p, tuple(x.shape), x.dtype)
           for p, x in zip(paths, tree_leaves(params))]
    if got != want:
        raise RuntimeError(f"the program's leaves {got} are not the "
                           f"configuration's {want}")
    init = make_params(c, G.weights_seed(seed), device)
    with torch.no_grad():
        for p, leaf in zip(paths, tree_leaves(params)):
            leaf.copy_(init[p])
    del init
    return model, params, paths


def change_norms(c: Dict, seed: int, current: Dict, device) -> Dict:
    """``{leaf: ||current - initial||}``, the initial weights made again."""
    init = make_params(c, G.weights_seed(seed), device)
    out = {p: G.norm(current[p].float() - x0.float())
           for p, x0 in init.items()}
    del init
    return out


class Zamba2QNStepCell(QNStepCell):
    """``QNStepCell`` over Zamba2 as published: its own model, weights,
    sigmas and reference; B1's f32 leaves priced at 4 bytes."""

    def __init__(self, ctx):
        super().__init__(ctx)
        self.cfg = program_config(ctx.config)

    def _batches(self, purpose: str, count: int):
        return G.batches_for(self.ctx.seed, purpose, count, self.rows,
                             self.seq, self.ctx.config["vocab_size"],
                             self.ctx.device)

    def setup(self):
        """As ``Glm4Cell.setup``, with this model and its weights."""
        import torch
        ctx, w, c = self.ctx, self.ctx.workload, self.ctx.config
        self.model, self.params, self.paths = build_model(
            c, self.cfg, ctx.seed, ctx.device, remat=w["remat"])
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

    def reference(self, key, lowp, fault):
        w, c = self.ctx.workload, self.ctx.config
        p = dict(w["protocol"], hist=c["qn_hist"])
        return Zamba2QNReference(c, p, w["sigmas"], w["byzantine"], self.m,
                                 key, lowp=lowp, fault=fault)

    def reference_readings(self, lowp: Optional[str] = None,
                           fault: Optional[str] = None) -> Dict:
        """As ``Glm4Cell.reference_readings``, with this model's
        weights."""
        import gc
        ctx, w, c = self.ctx, self.ctx.workload, self.ctx.config
        params = make_params(c, G.weights_seed(ctx.seed), ctx.device)
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

    def control_numbers(self, fault: Optional[str] = None
                        ) -> Dict[str, float]:
        """``Glm4Cell.control_numbers``; ``fault`` may also name a reading
        in a lower precision (``LOWP``: the scan in bf16)."""
        if fault not in LOWP:
            return super().control_numbers(fault)
        low = self.reference_readings(fault)
        if self.ref_readings is None:
            self.ref_readings = self.reference_readings()
        return G.compare(low, self.ref_readings)

    def b1_launches(self):
        """Per step, five aggregations of every leaf, (1, m, d_leaf) in
        the leaf's dtype on the wire: bf16, and f32 for ``a_log``,
        ``dt_bias`` and ``d_skip``."""
        c = self.ctx.config
        return [(1, self.m, math.prod(shape),
                 leaf_dtype(c, p).itemsize, self.transmissions)
                for p, shape, _ in leaf_specs(c)]
