"""The dry run: every (arch x shape) traced as one rank's step on the meta
device against the modelled H100 machine — ``repro/launch/dryrun.py``
counterpart.

Usage (no card needed; the CPU runs it):
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --both-meshes
  python -m repro_torch.launch.dryrun ... --agg dcq --strategy sharded

The reference lowers and compiles each combination for 512 fake TPU
devices and reads XLA's analyses. Here ``trace_one`` builds the model on
the meta device at full size, takes this rank's share of everything on
the production mesh (``launch.mesh``: (data 32, model 8), or (pod 2,
data 32, model 8)) and runs the port's own step on meta tensors under
``launch.roofline.CountingMode``:

  * train: the AdamW step (``train.trainer.make_train_step``) on the
    mesh: n_machines = chips / model, one or more machines a data rank,
    the payload dims over "model" (``dist.payload``: each layer's weights
    gathered before it, its gradient reduce-scattered after), the
    robust aggregation of each leaf's ``(m, d / model)`` slice;
  * prefill: the forward and the last position's logits;
  * decode: one ``decode_step`` against a cache at position S - 1.

A batch is split over the machine axis ("data" x "pod") and then over
"model" where it divides, and replicated where it does not (long_500k's
B = 1; prefill's 32 rows over 256 cards), through the trainers' own
``MachineMap.local`` and ``Payload.rows``: the per-device FLOPs show that
cost. This is the port's program, FSDP over "model", not the reference's
GSPMD tensor parallelism. Every figure is a prediction from datasheet
constants. ``run_one`` writes one JSON per combination under ``--outdir``
(default ``experiments/dryrun``, which git ignores).

Three of the reference's flags have no counterpart: ``--fsdp`` (the
machine axis is "data", and the trainers refuse fsdp over it),
``--kv-mode`` (a rank's decode holds its rows of the cache whole) and
``--skip-probes`` (the trace is whole; nothing is extrapolated).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.shapes import adapt_config, input_specs
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh

__all__ = ["trace_one", "run_one", "main"]


def _mesh_name(mesh: Dict[str, int]) -> str:
    return "x".join(str(n) for n in mesh.values())


def _rank_rows(batch: Dict[str, Any], mesh: Dict[str, int], pl
               ) -> Dict[str, Any]:
    """This rank's rows of an inference batch, as the trainers take a
    machine's: its block over the machine axis (``MachineMap.local``)
    where the rows divide, replicated where they do not, then
    ``Payload.rows`` over "model"."""
    from repro_torch.dist.sharded_protocol import machine_map
    mm = machine_map(mesh)
    if next(iter(batch.values())).shape[0] % mm.world == 0:
        batch = {k: mm.local(v) for k, v in batch.items()}
    return batch if pl is None else pl.rows(batch)


def _cfg(arch, shape, cfg_override, moe_cf, moe_shard, moe_dispatch):
    cfg = cfg_override if cfg_override is not None \
        else adapt_config(get_config(arch), shape)
    if cfg.moe is not None and (moe_cf or moe_shard or moe_dispatch):
        moe = cfg.moe
        if moe_cf:
            moe = dataclasses.replace(moe, capacity_factor=moe_cf)
        if moe_shard:
            moe = dataclasses.replace(moe, shard_buffers=True)
        if moe_dispatch:
            moe = dataclasses.replace(moe, dispatch_shards=moe_dispatch)
        cfg = dataclasses.replace(cfg, moe=moe)
    return cfg


def trace_one(arch: str, shape_name: str, multi_pod: bool = False,
              agg: str = "dcq", strategy: str = "replicated",
              cfg_override=None, grad_dtype: str = "", moe_cf: float = 0.0,
              microbatch: int = 0, moe_shard: bool = False,
              moe_dispatch: int = 0, mesh: Optional[Dict[str, int]] = None,
              n_machines: Optional[int] = None):
    """Trace one combination; returns ``(counts, cfg, shape, meta)``.
    ``mesh`` (default: the production mesh) is an axis-size mapping;
    ``n_machines`` (default: chips / model) the train step's machines."""
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.dist.payload import maybe_active, payload_for
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainConfig, make_train_step
    shape = SHAPES[shape_name]
    cfg = _cfg(arch, shape, cfg_override, moe_cf, moe_shard, moe_dispatch)
    mesh = dict(mesh) if mesh is not None \
        else make_production_mesh(multi_pod=multi_pod)
    chips = math.prod(mesh.values())
    model = Model(cfg, device="meta", remat=True)
    specs = input_specs(cfg, shape)
    counts = roofline.CountingMode()
    if shape.kind == "train":
        m = n_machines or chips // mesh.get("model", 1)
        tcfg = TrainConfig(n_machines=m, remat=True, grad_dtype=grad_dtype,
                           microbatch=microbatch,
                           agg=GradAggConfig(method=agg, dp_sigma=1e-5,
                                             strategy=strategy))
        opt = AdamW(lr=1e-4)
        step = make_train_step(model, opt, tcfg, mesh)
        pl = step.payload
        params = model.params() if pl is None else pl.shard(model.params())
        state = opt.init(params)
        key = torch.Generator().manual_seed(0)
        counts.track(params, state, specs)
        with counts:
            step(params, state, specs, key)
        rows = None         # a machine's rows, each split by the step
    else:
        pl = payload_for(model, mesh)
        params = model.params() if pl is None else pl.shard(model.params())
        if shape.kind == "prefill":
            batch = _rank_rows(specs, mesh, pl)
            counts.track(params, batch)
            with counts, torch.no_grad(), maybe_active(pl):
                logits, _ = model.forward(batch, params=params)
                logits[:, -1]
        else:
            batch = _rank_rows({"tokens": specs["tokens"]}, mesh, pl)
            cache = model.init_cache(batch["tokens"].shape[0],
                                     shape.seq_len)
            cache["pos"] = shape.seq_len - 1
            counts.track(params, batch, cache)
            with counts, maybe_active(pl):
                logits, cache = model.decode_step(cache, batch,
                                                  params=params)
                torch.argmax(logits[:, -1], dim=-1)
        rows = batch["tokens"].shape[0]
    meta = {"arch": arch, "shape": shape_name, "mesh": _mesh_name(mesh),
            "mesh_axes": mesh, "chips": chips, "agg": agg,
            "strategy": strategy, "kind": shape.kind,
            "sliding_window": cfg.sliding_window, "rows_per_device": rows,
            "launches": dict(counts.launches),
            "kernel_bytes": dict(counts.kernel_bytes), "ops": counts.ops}
    return counts, cfg, shape, meta


def run_one(arch: str, shape_name: str, multi_pod: bool, outdir: str,
            agg: str, strategy: str, grad_dtype: str = "",
            moe_cf: float = 0.0, microbatch: int = 0, tag_extra: str = "",
            moe_shard: bool = False, moe_dispatch: int = 0) -> dict:
    """Trace one combination, write its JSON (the reference's keys where
    they mean the same) and print the reference's one-line summary."""
    t0 = time.time()
    counts, cfg, shape, meta = trace_one(
        arch, shape_name, multi_pod, agg, strategy, grad_dtype=grad_dtype,
        moe_cf=moe_cf, microbatch=microbatch, moe_shard=moe_shard,
        moe_dispatch=moe_dispatch)
    report = roofline.analyze(counts, cfg, shape, meta["mesh"],
                              meta["chips"], arch)
    meta.update(report.asdict())
    meta["compile_s"] = time.time() - t0
    meta["prediction"] = "datasheet constants (launch.mesh), not measured"
    meta["variant"] = tag_extra
    os.makedirs(outdir, exist_ok=True)
    tag = f"{arch}_{shape_name}_{meta['mesh']}_{agg}_{strategy}{tag_extra}"
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    print(f"[dryrun] {tag}: OK in {meta['compile_s']:.1f}s | "
          f"dominant={meta['dominant']} compute={meta['compute_s']:.4g}s "
          f"memory={meta['memory_s']:.4g}s "
          f"collective={meta['collective_s']:.4g}s | "
          f"peak_mem={meta['peak_memory_bytes']}", flush=True)
    return meta


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Trace one rank's step of every (arch x shape) on the "
        "meta device against the modelled H100 machine (no card needed).")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--agg", default="dcq",
                    choices=["mean", "median", "trimmed", "dcq"])
    ap.add_argument("--strategy", default="replicated",
                    choices=["replicated", "sharded"])
    ap.add_argument("--grad-dtype", default="")
    ap.add_argument("--moe-cf", type=float, default=0.0)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--moe-shard", action="store_true")
    ap.add_argument("--moe-dispatch", type=int, default=0)
    ap.add_argument("--tag", default="")
    ap.add_argument("--outdir", default="experiments/dryrun")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_one(arch, shape, mp, args.outdir, args.agg,
                            args.strategy, args.grad_dtype, args.moe_cf,
                            args.microbatch, args.tag, args.moe_shard,
                            args.moe_dispatch)
                except Exception as e:
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
    if failures:
        print("FAILURES:")
        for f in failures:
            print("  ", f)
        sys.exit(1)
    print("all dry-runs OK")


if __name__ == "__main__":
    main()
