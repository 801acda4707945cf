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
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core.transport import tree_leaves, tree_map

__all__ = ["RingBuffer"]


class RingBuffer:
    """A ``(capacity, *leaf)`` stack per leaf of ``template`` (one machine
    update: a tree of tensors, whose shapes and dtypes are taken), on
    ``device`` (the card unless given). ``block`` is the bulk-ingest chunk
    size."""

    def __init__(self, template: Any, capacity: int, block: int = 64,
                 device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.block = max(1, min(int(block), self.capacity))
        self.cursor = 0          # total writes since reset
        self.device = resolve_device(device)
        self.arrays = tree_map(
            lambda leaf: torch.zeros((self.capacity,) + tuple(leaf.shape),
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
        oldest slot. Returns the slot index written."""
        idx = self.cursor % self.capacity
        for buf, x in zip(self._leaves, tree_leaves(update)):
            buf[idx].copy_(x)
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
        at = self.cursor
        for buf, x in zip(self._leaves, tree_leaves(rows)):
            buf[at:at + self.block].copy_(x[start:start + self.block])
        self.cursor += self.block

    def reset(self) -> None:
        """Start a new round: the stale rows stay in place; the masked
        aggregation never reads past ``fill``."""
        self.cursor = 0
