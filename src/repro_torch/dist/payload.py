"""Payload dims over a mesh's "model" axis: every leaf that
``models.sharding.param_spec`` puts on "model" is held on a rank as its
``1 / model`` slice along that dim.

The reference shards payload dims by GSPMD: XLA inserts the collectives
its tensor-parallel program needs. Here the program is the port's own,
FSDP over "model", one code path for all six families:

  * a rank holds the slice of every model-sharded parameter, and with it
    the slice of its AdamW moments, of every machine's gradient row and,
    in the QN step, of the L-BFGS memory and every round's buffers;
  * the model gathers a layer's full weights over the model group right
    before the layer (``models.blocks.layer_view``; inside the layer's
    rematerialised region, so a gathered layer is freed after it), and
    the gather's backward reduce-scatters the layer's gradient back to
    the slices;
  * a machine's batch rows are split over the model group where they
    divide (and its loss is linear in them: not the MoE's load-balance
    loss, whose rows are replicated; :func:`payload_for` decides), each
    model rank computing the gradient of its rows; the slices' gradients
    are then the mean over the model group, and a replicated leaf's
    gradient is all-reduced to that mean. Rows that do not divide are
    replicated, each model rank doing the same work;
  * the robust aggregation is coordinate-wise, so each rank aggregates
    its ``(m, d / model)`` slice after gathering the machine rows over
    the machine group only (``collectives.gather_machines``);
  * every whole-tree reduction (the global-norm clip, ``tree_dot`` in the
    two-loop, gamma and the gradient norm) goes through
    ``core.transport.leaf_sum``, which all-reduces the sharded leaves'
    part over the model group and counts a replicated leaf once;
  * DP sigmas are the whole leaf's (:meth:`Payload.full_like`); passed-in
    draws, which are whole leaves, are cut to this rank's slice, and a
    generator's draws for a sharded leaf come from a generator forked
    once a step by model rank (:meth:`Payload.fork`), so no rank draws a
    whole leaf and the slices' noise is independent; a replicated leaf
    draws from the step's generator itself, alike on every rank.

``Payload.active()`` makes a payload the one the step runs under
(``core.transport.active_payload``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, List, Optional

import torch

from repro_torch.core import transport
from repro_torch.core.transport import (leaf_paths, tree_flatten,
                                        tree_leaves, tree_unflatten)
from repro_torch.dist.collectives import MeshAxis, mesh_axis
from repro_torch.models import sharding as shd

__all__ = ["Payload", "payload_for", "maybe_active"]


class _Gather(torch.autograd.Function):
    """The all-gather of a slice over the model group; its backward
    reduce-scatters the full gradient to the mean over the group (rows
    split) or keeps this rank's block of it (rows replicated: every rank
    holds the same gradient)."""

    @staticmethod
    def forward(ctx, x, axis: MeshAxis, dim: int, split: bool):
        ctx.axis, ctx.dim, ctx.split = axis, dim, split
        return axis.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        if ctx.split:
            return axis.reduce_scatter(g, dim, avg=True), None, None, None
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.rank * n, n).contiguous(), None, None, None


class Payload:
    """The payload sharding of a parameter tree over ``mesh``'s "model"
    axis on this rank. ``tree`` is the whole tree (any device, the meta
    device included), from which each leaf's sharded dim is read;
    ``split_rows`` whether a machine's rows may be split over the model
    group."""

    def __init__(self, tree: Any, mesh: Any, split_rows: bool = True):
        self.axis: MeshAxis = mesh_axis(mesh, "model")
        if self.axis is None:
            raise ValueError(f"mesh {shd.mesh_shape(mesh)} has no 'model' "
                             f"axis")
        self.paths = leaf_paths(tree)
        self.dims: List[Optional[int]] = []
        for path, leaf in zip(self.paths, tree_leaves(tree)):
            spec = shd.param_spec(tuple(path.split("/")), tuple(leaf.shape),
                                  mesh)
            d = next((i for i, a in enumerate(spec) if a == "model"), None)
            # counted from the end: the same dim on a stacked leaf, on its
            # layer slice and under a leading machine axis
            self.dims.append(None if d is None else d - len(spec))
        self.by_path: Dict[str, Optional[int]] = dict(zip(self.paths,
                                                          self.dims))
        self.split_rows = split_rows
        self.rows_split = False
        self._forks: Dict[int, tuple] = {}

    # ---------------------------------------------------------- the tree
    def _block(self, x: torch.Tensor, d: int) -> torch.Tensor:
        n = x.shape[d] // self.axis.size
        return x.narrow(d, self.axis.rank * n, n)

    def shard(self, tree: Any) -> Any:
        """This rank's tree: the slice of every sharded leaf of the whole
        ``tree`` (contiguous copies, detached), the other leaves as
        detached copies."""
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            (x if d is None else self._block(x, d)).detach().clone()
            for x, d in zip(leaves, self.dims)])

    def local(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of a whole-leaf tensor of leaf ``i`` (any
        leading axes)."""
        d = self.dims[i]
        return x if d is None else self._block(x, d)

    def unshard(self, tree: Any) -> Any:
        """The whole tree from every rank's slices (a collective over the
        model group)."""
        leaves, treedef = tree_flatten(tree)
        return tree_unflatten(treedef, [
            x if d is None else self.axis.all_gather(x, d)
            for x, d in zip(leaves, self.dims)])

    def full_like(self, tree: Any) -> Any:
        """Meta tensors of the whole leaves' shapes (any leading axes):
        what the DP calibration and the sharding specs read."""
        leaves, treedef = tree_flatten(tree)
        out = []
        for x, d in zip(leaves, self.dims):
            shape = list(x.shape)
            if d is not None:
                shape[d] *= self.axis.size
            out.append(torch.empty(shape, dtype=x.dtype, device="meta"))
        return tree_unflatten(treedef, out)

    # ------------------------------------------------------- the model
    def gather(self, x: torch.Tensor, path: str) -> torch.Tensor:
        """Leaf ``path``'s whole tensor from this rank's slice ``x`` (or
        ``x`` itself for a replicated leaf), differentiable."""
        d = self.by_path.get(path)
        if d is None:
            return x
        return _Gather.apply(x, self.axis, d, self.rows_split)

    def rows(self, batch: Dict[str, torch.Tensor]
             ) -> Dict[str, torch.Tensor]:
        """This rank's rows of one machine's batch: the model group splits
        them where they divide and ``split_rows`` allows, and they are
        replicated otherwise (sets :attr:`rows_split`)."""
        B = next(iter(batch.values())).shape[0]
        size = self.axis.size
        self.rows_split = bool(self.split_rows and "mask" not in batch
                               and B % size == 0)
        if not self.rows_split:
            return batch
        n = B // size
        return {k: v.narrow(0, self.axis.rank * n, n)
                for k, v in batch.items()}

    def finish(self, loss: torch.Tensor, grads):
        """The machine's loss and gradient from this rank's rows: with the
        rows split, the loss and the replicated leaves' gradients are
        averaged over the model group (the slices' were in the gather's
        backward)."""
        if not self.rows_split:
            return loss, grads
        grads = [g if d is not None else self.axis.all_reduce(g, avg=True)
                 for g, d in zip(grads, self.dims)]
        return self.axis.all_reduce(loss, avg=True), grads

    # ------------------------------------------------------ reductions
    def leaf_sum(self, parts: List[Any]):
        """``core.transport.leaf_sum`` under this payload: the sharded
        leaves' parts summed, then over the model group, plus the
        replicated leaves' parts once."""
        if len(parts) != len(self.dims):
            raise ValueError(f"{len(parts)} per-leaf parts for a payload "
                             f"of {len(self.dims)} leaves")
        sharded = [p for p, d in zip(parts, self.dims) if d is not None]
        total = sum(p for p, d in zip(parts, self.dims) if d is None)
        if sharded:
            total = total + self.axis.all_reduce(sum(sharded))
        return total

    # ------------------------------------------------------- the draws
    def fork(self, gen: torch.Generator) -> torch.Generator:
        """The generator a sharded leaf draws from in place of ``gen``:
        made once per :meth:`active` scope from one draw of ``gen`` (the
        same on every rank) and this rank's model coordinate."""
        hit = self._forks.get(id(gen))
        if hit is None:
            seed = int(torch.randint(0, 2 ** 62, (), generator=gen,
                                     device=gen.device))
            fork = torch.Generator(device=gen.device)
            # repro-torch: allow(generator-seeding) — the seed is a uniform
            # 62-bit draw of the step's generator, alike on every rank, plus
            # this rank's model coordinate: two forks collide only if two draws
            # land within the model axis's size
            fork.manual_seed(seed + self.axis.rank)
            hit = self._forks[id(gen)] = (gen, fork)
        return hit[1]

    def leaf_key(self, i: int, z: Any) -> Any:
        """Leaf ``i``'s draws: a whole-leaf tensor of standard normals cut
        to this rank's slice, a generator forked for a sharded leaf, or
        ``z`` itself."""
        if self.dims[i] is None or z is None:
            return z
        if isinstance(z, torch.Tensor):
            return self.local(z, i)
        return self.fork(z)

    @contextlib.contextmanager
    def active(self) -> Iterator["Payload"]:
        """The scope of one step under this payload."""
        self._forks = {}
        token = transport._PAYLOAD.set(self)
        try:
            yield self
        finally:
            transport._PAYLOAD.reset(token)
            self._forks = {}


def payload_for(model: Any, mesh: Any) -> Optional[Payload]:
    """The payload of ``model``'s parameters (a ``models.model.Model``,
    any device) over ``mesh``, or None where the mesh has no "model" axis
    of more than one rank (every leaf whole here). A machine's rows may be
    split over the model group unless the model is an MoE: its
    load-balance loss is not linear in the rows."""
    if mesh is None:
        return None
    if shd.mesh_shape(mesh).get("model", 1) <= 1:
        return None
    return Payload(model.params(), mesh,
                   split_rows=model.cfg.family != "moe")


@contextlib.contextmanager
def maybe_active(pl: Optional[Payload]) -> Iterator[Optional[Payload]]:
    """``pl.active()``, or nothing for None."""
    if pl is None:
        yield None
    else:
        with pl.active():
            yield pl
