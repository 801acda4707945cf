"""Robust aggregation over a machine axis sharded across ranks —
``repro/dist/collectives.py`` counterpart on ``torch.distributed``.

The reference is single-controller SPMD: ``shard_map`` over the machine
axis, a tiled ``all_gather`` of the machine rows, then
``aggregate_machine_axis`` on the full axis on every device. Here each
rank is a process that holds its own rows, ``(m / world, ...)``, rank r
holding machines ``[r * m / world, (r + 1) * m / world)``. The schedule is
the same:

    gather_machines: all-gather the rows in rank order   # the collective
      -> aggregate_machine_axis on the full (m, ...) axis  # the same math

so every rank ends with the same aggregate, and on the card the
aggregation is one launch of B1 per leaf, as on one device. The gather's
concatenation is the machine order by construction, so the result equals
the unsharded path's bit for bit (the same program on the same array).

A mesh is a 1-D ``DeviceMesh`` whose one dim is the machine axis
(``launch.cli.machine_mesh`` makes it); its process group runs the
gather: NCCL on the card, gloo on the CPU (and gloo gathers CUDA tensors
too, through host buffers).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.agg import get_aggregator
from repro_torch.core.transport import leaf_paths, tree_leaves, tree_map
from repro_torch.dist.grad_agg import GradAggConfig, aggregate_machine_axis
from repro_torch.models import sharding as shd

__all__ = ["mesh_group", "gather_machines", "tree_machine_specs",
           "check_spec", "sharded_aggregate_leaf"]


def mesh_group(mesh: Any):
    """The process group of a 1-D mesh's machine axis."""
    if mesh.ndim != 1:
        raise NotImplementedError(
            "the port shards the machine axis alone: a mesh of more than "
            "one dim is ROADMAP A12")
    return mesh.get_group()


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # ``all_gather_single`` is the newer name of ``all_gather_into_tensor``,
    # which newer torch releases deprecate: take whichever exists first
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x, group=group)


def gather_machines(x: torch.Tensor, mesh: Any, dim: int = 0
                    ) -> torch.Tensor:
    """The full machine axis from every rank's rows: ``x`` holds this
    rank's ``k`` rows along ``dim``; the result holds ``world * k``, rank
    0's first (the machine order). On every rank of the mesh, in the same
    order (a collective)."""
    group = mesh_group(mesh)
    world = dist.get_world_size(group)
    rows = x.movedim(dim, 0).contiguous()
    out = torch.empty((world * rows.shape[0],) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    _all_gather(out, rows, group)
    # in the layout the unsharded path has: a strided view would send the
    # reductions after it down another summation order
    return out.movedim(0, dim).contiguous()


def tree_machine_specs(tree: Any, mesh: Any, fsdp: bool = False,
                       machine_axis=None) -> Any:
    """Per-leaf specs of a machine-stacked tree: the machine axis first,
    on the mesh's batch axes (its first axis on a pure machine mesh such
    as the 1-D ``("machines",)``), and every payload dim by
    ``models.sharding.param_spec``."""
    axes = shd.mesh_shape(mesh)
    ax = machine_axis if machine_axis is not None else shd.batch_axes(axes)
    if isinstance(ax, str) and ax not in axes:
        ax = next(iter(axes))
    specs = iter([(ax,) + shd.param_spec(tuple(path.split("/")),
                                         tuple(leaf.shape[1:]), axes,
                                         fsdp=fsdp)
                  for path, leaf in zip(leaf_paths(tree),
                                        tree_leaves(tree))])
    return tree_map(lambda _: next(specs), tree)


def check_spec(cfg: GradAggConfig, spec: Optional[tuple]) -> None:
    """The reference's contract for a sharded leaf: a rule that is not
    coordinate-wise needs its payload dims replicated."""
    name = "dcq_mad" if cfg.method == "dcq" else cfg.method
    try:
        coordinatewise = get_aggregator(name).coordinatewise
    except KeyError:
        raise ValueError(f"unknown aggregation method {cfg.method!r}") \
            from None
    if spec and not coordinatewise and any(s is not None for s in spec[1:]):
        raise ValueError(
            f"{cfg.method} is not coordinate-wise: payload dims must be "
            f"replicated in the sharded strategy, got spec {spec}")


def sharded_aggregate_leaf(values: torch.Tensor, cfg: GradAggConfig,
                           mesh: Any, spec: tuple) -> torch.Tensor:
    """Aggregate one leaf whose machine axis is sharded: ``values`` holds
    this rank's ``(m / world, ...)`` rows, ``spec[0]`` names the machine
    axis (``None``: the rows are the whole axis, nothing to gather).
    Returns the ``values.shape[1:]`` aggregate, the same on every rank."""
    check_spec(cfg, spec)
    if not spec or spec[0] is None:
        return aggregate_machine_axis(values, cfg)
    return aggregate_machine_axis(gather_machines(values, mesh), cfg)
