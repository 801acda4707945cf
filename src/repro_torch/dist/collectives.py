"""Robust aggregation over a machine axis sharded across ranks, and the
mesh's axes as process groups — ``repro/dist/collectives.py`` counterpart
on ``torch.distributed``.

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

A mesh is a ``DeviceMesh``: 1-D, its one dim the machine axis
(``launch.cli.machine_mesh``), or ``("data", "model")`` /
``("pod", "data", "model")`` (``launch.mesh.make_host_mesh``), whose
machine axis is "data" (x "pod", ``models.sharding.batch_axes``) and
whose "model" axis shards payload dims (``dist.payload``). Every rule the
reference applies is coordinate-wise, so a rank aggregates its own
``(m, d / model)`` slice of a model-sharded leaf with no communication
over "model": the gather runs over the machine group only. NCCL on the
card, gloo on the CPU (and gloo gathers CUDA tensors too, through host
buffers).

A mesh may also be a plain mapping ``{axis name: size}`` (the dry run's
production mesh, ``launch.mesh.make_production_mesh``): it has no process
group, and this rank is rank 0 of each axis. Its collectives take meta
tensors only: each is one op, ``repro_torch::collective``, whose meta
rule gives the result's shape and which the dry run's counting mode
(``launch.roofline``) records by kind, axis and result bytes. A tensor
that holds data is refused, since no group would bring the other ranks'
part. An axis of size 1 moves nothing: its collectives return their
input.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.agg import get_aggregator
from repro_torch.core.transport import leaf_paths, tree_leaves, tree_map
from repro_torch.dist.grad_agg import GradAggConfig, aggregate_machine_axis
from repro_torch.models import sharding as shd

__all__ = ["MeshAxis", "traced_collective", "mesh_axis", "mesh_group",
           "machine_axes", "gather_machines", "tree_machine_specs",
           "check_spec", "sharded_aggregate_leaf"]


@torch.library.custom_op("repro_torch::collective", mutates_args=())
def traced_collective(x: torch.Tensor, kind: str, axis: str, size: int,
                      dim: int) -> torch.Tensor:
    """A collective (``kind``: "all-gather", "all-reduce" or
    "reduce-scatter") over ``axis`` of a mapping mesh as one op of a
    meta-device trace. It has only the meta rule: a mapping mesh has no
    process group, so a tensor that holds data cannot take it."""
    raise ValueError(
        f"{kind} over {axis!r} of a mapping mesh: it has no process group, "
        f"so only a meta tensor (a dry-run trace) can take its collectives; "
        f"give a DeviceMesh (launch.mesh.make_host_mesh) to run on "
        f"{x.device.type} tensors")


@traced_collective.register_fake
def _traced_collective_meta(x, kind, axis, size, dim):
    shape = list(x.shape)
    if kind == "all-gather":
        shape[dim] *= size
    elif kind == "reduce-scatter":
        shape[dim] //= size
    return x.new_empty(shape)


def machine_axes(mesh: Any) -> tuple:
    """The names of the mesh's machine axes: its batch axes ("pod",
    "data") where it has them, else its first axis (a 1-D machine
    mesh)."""
    axes = shd.mesh_shape(mesh)
    ax = shd.batch_axes(axes)
    names = ax if isinstance(ax, tuple) else (ax,)
    names = tuple(n for n in names if n in axes)
    return names or (next(iter(axes)),)


_FLAT: dict = {}


def _subgroup(mesh: Any, names: tuple):
    if len(names) == 1:
        return mesh.get_group(names[0]) if mesh.ndim > 1 \
            else mesh.get_group()
    key = (id(mesh), names)
    if key not in _FLAT:
        # one flattened dim over the machine axes (every rank makes it)
        _FLAT[key] = (mesh, mesh[names]._flatten().get_group())
    return _FLAT[key][1]


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a mesh (or the product of the machine axes) as a
    process group: its ``name``, ``size``, this process's ``rank`` on it,
    and the ``group`` (None on a mapping mesh, whose collectives only
    trace: :func:`traced_collective`)."""
    name: str
    size: int
    rank: int = 0
    group: Any = None

    def _traced(self, x: torch.Tensor, kind: str, dim: int = 0
                ) -> torch.Tensor:
        return traced_collective(x, kind, self.name, self.size, dim)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order, in
        the layout of an unsharded tensor."""
        if self.size == 1:
            return x
        if self.group is None:
            return self._traced(x, "all-gather", dim)
        rows = x.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * rows.shape[0],) + tuple(rows.shape[1:]),
                          dtype=rows.dtype, device=rows.device)
        # ``all_gather_single`` is the newer name of
        # ``all_gather_into_tensor``: take whichever exists first
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, rows, group=self.group)
        # in the layout the unsharded path has: a strided view would send
        # the reductions after it down another summation order
        return out.movedim(0, dim).contiguous()

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group of a new tensor ``x``. Gloo reduces on
        the host in f32 (a CUDA or bf16 tensor goes there and back)."""
        if dist.get_backend(self.group) == "nccl":
            dist.all_reduce(x, group=self.group)
            return x
        host = x.to("cpu", torch.float32)
        dist.all_reduce(host, group=self.group)
        return host.to(x.device, x.dtype)

    def all_reduce(self, x: torch.Tensor, avg: bool = False
                   ) -> torch.Tensor:
        """The sum (or mean) of every rank's ``x``, a new tensor."""
        if self.size == 1:
            return x
        out = self._traced(x, "all-reduce") if self.group is None \
            else self._sum(x.clone())
        return out / self.size if avg else out

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       avg: bool = False) -> torch.Tensor:
        """This rank's ``1 / size`` block along ``dim`` of the sum (or
        mean) of every rank's ``x``. NCCL reduce-scatters; gloo, which
        has no reduce-scatter of its own, all-reduces and keeps the
        block (twice the traffic, the same numbers)."""
        if self.size == 1:
            return x
        n = x.shape[dim] // self.size
        if self.group is None:
            out = self._traced(x, "reduce-scatter", dim)
            return out / self.size if avg else out
        if dist.get_backend(self.group) == "nccl":
            rows = x.movedim(dim, 0).contiguous()
            out = torch.empty((n,) + tuple(rows.shape[1:]), dtype=x.dtype,
                              device=x.device)
            scatter = getattr(dist, "reduce_scatter_single", None) \
                or dist.reduce_scatter_tensor
            scatter(out, rows, group=self.group)
            out = out.movedim(0, dim)
        else:
            out = self._sum(x.contiguous().clone()).narrow(
                dim, self.rank * n, n)
        out = out.contiguous()
        return out / self.size if avg else out


def mesh_axis(mesh: Any, axis: str = "machines") -> Optional[MeshAxis]:
    """``axis`` of ``mesh`` as a :class:`MeshAxis`: ``"machines"`` is the
    machine axis (:func:`machine_axes`, their product on a pod mesh),
    anything else a mesh dim by name (None where the mesh has no such
    dim)."""
    axes = shd.mesh_shape(mesh)
    names = machine_axes(mesh) if axis == "machines" else (axis,)
    if any(n not in axes for n in names):
        return None
    size = 1
    for n in names:
        size *= axes[n]
    label = "+".join(names)
    if isinstance(mesh, Mapping):
        return MeshAxis(label, size)
    group = _subgroup(mesh, names)
    return MeshAxis(label, dist.get_world_size(group),
                    dist.get_rank(group), group)


def mesh_group(mesh: Any, axis: str = "machines"):
    """The process group of the mesh's machine axis (``axis="model"``: of
    its model axis; None where it has none, or on a mapping mesh)."""
    ax = mesh_axis(mesh, axis)
    return None if ax is None else ax.group


def gather_machines(x: torch.Tensor, mesh: Any, dim: int = 0
                    ) -> torch.Tensor:
    """The full machine axis from every rank's rows: ``x`` holds this
    rank's ``k`` rows along ``dim``; the result holds ``world * k``, rank
    0's first (the machine order). On every rank of the machine group, in
    the same order (a collective); over the machine group only, so each
    model rank gathers its own payload slice."""
    return mesh_axis(mesh, "machines").all_gather(x, dim)


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
