"""Fixed-capacity ring buffers for streaming ingest —
``repro/serve/buffers.py`` counterpart.

One buffer slot per machine update: a tree of preallocated ``(capacity,
*leaf)`` tensors on the device plus a host-side cursor. Ingest writes in
place: one row with one ``copy_`` per leaf, or a block of rows with one
``copy_`` per leaf, so an arrival never reallocates the buffer. The
reference donates its buffers to jitted writers and counts their traces;
eager PyTorch has no traces, so there are no trace counts here.

Invariant consumed by the masked aggregation: the valid rows are always
the contiguous prefix ``[0, fill)``. Below capacity the cursor IS the
fill; at capacity the cursor wraps (the oldest row is overwritten) and
every slot stays valid.

Across ranks (``sharding=mesh``, a 1-D machine mesh from
``launch.cli.machine_mesh``): the capacity axis is split over the mesh's
W ranks as the reference's ``PartitionSpec("machines")`` places it, rank
r holding the contiguous slots ``[r * C/W, (r + 1) * C/W)``, so the
capacity must divide by W. Every rank is handed the same arrival stream
(the SPMD contract the launchers' ranks keep: the same data from the
same seed); a write lands only in the slots this rank owns, and the
cursor advances on every rank, so ``fill`` is the same host int
everywhere. ``arrays`` then holds this rank's ``(C/W, *leaf)`` rows;
the flush gathers them in machine order (``dist.collectives``).
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.transport import tree_leaves, tree_map
from repro_torch.dist.collectives import mesh_group

__all__ = ["RingBuffer"]


class RingBuffer:
    """A ``(capacity, *leaf)`` stack per leaf of ``template`` (one machine
    update: a tree of tensors, whose shapes and dtypes are taken), on
    ``device`` (the card unless given). ``block`` is the bulk-ingest chunk
    size. ``sharding``: a 1-D machine mesh over which the capacity axis is
    split (see the module docstring), or None."""

    def __init__(self, template: Any, capacity: int, block: int = 64,
                 device=None, sharding: Optional[Any] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.block = max(1, min(int(block), self.capacity))
        self.cursor = 0          # total writes since reset
        self.device = resolve_device(device)
        self.mesh = sharding
        self.lo, self.hi = 0, self.capacity     # the slots held here
        if sharding is not None:
            group = mesh_group(sharding)
            world, rank = dist.get_world_size(group), dist.get_rank(group)
            if self.capacity % world:
                raise ValueError(
                    f"capacity {self.capacity} does not shard evenly over "
                    f"{world} devices on axis 'machines': the global size "
                    f"of dimension 0 should be divisible by {world}")
            rows = self.capacity // world
            self.lo, self.hi = rank * rows, (rank + 1) * rows
        self.arrays = tree_map(
            lambda leaf: torch.zeros((self.hi - self.lo,)
                                     + tuple(leaf.shape),
                                     dtype=leaf.dtype, device=self.device),
            template)
        self._leaves = tree_leaves(self.arrays)

    @property
    def fill(self) -> int:
        """Number of valid rows (the contiguous prefix)."""
        return min(self.cursor, self.capacity)

    @property
    def full(self) -> bool:
        return self.cursor >= self.capacity

    def push(self, update: Any) -> int:
        """Write one machine update; at capacity the ring wraps onto the
        oldest slot. Returns the slot index written (on a sharded buffer,
        the global slot, written only by the rank that holds it)."""
        idx = self.cursor % self.capacity
        if self.lo <= idx < self.hi:
            for buf, x in zip(self._leaves, tree_leaves(update)):
                buf[idx - self.lo].copy_(x)
        self.cursor += 1
        return idx

    def push_block(self, rows: Any, start: int) -> None:
        """Write ``rows[start:start + block]`` (every leaf stacked on a
        leading axis) at the cursor. Refuses when the buffer has no room
        for a whole block (no wrap mid-block)."""
        if self.fill + self.block > self.capacity:
            raise ValueError("push_block needs room for a full block; "
                             f"fill={self.fill} block={self.block} "
                             f"capacity={self.capacity}")
        # this rank's share of the global slots [cursor, cursor + block)
        a = max(self.cursor, self.lo)
        b = min(self.cursor + self.block, self.hi)
        if a < b:
            src = start + a - self.cursor
            for buf, x in zip(self._leaves, tree_leaves(rows)):
                buf[a - self.lo:b - self.lo].copy_(x[src:src + b - a])
        self.cursor += self.block

    def check_fill(self) -> None:
        """On a sharded buffer, that every rank holds the same fill (one
        all-reduce of the fill's min and max); raises where they differ."""
        if self.mesh is None:
            return
        group = mesh_group(self.mesh)
        on = self.device if dist.get_backend(group) == "nccl" else "cpu"
        x = torch.tensor([self.fill, -self.fill], dtype=torch.int64,
                         device=on)
        dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
        lo, hi = int(x[0]), -int(x[1])
        if lo != hi:
            raise ValueError(f"the ranks hold different fills (from {lo} "
                             f"to {hi}): every rank must be handed the "
                             f"same arrival stream")

    def reset(self) -> None:
        """Start a new round: the stale rows stay in place; the masked
        aggregation never reads past ``fill``."""
        self.cursor = 0
