"""Flush policy: when does the buffered fleet become a model update? —
``repro/serve/flush.py`` counterpart, the same host-side logic.

A flush fires when the buffer reaches a capacity fraction, when the
oldest pending update has waited past a deadline, or when the caller asks
explicitly. ``min_fill`` floors every trigger — a robust aggregator
over two machines is not meaningfully robust — and ``backpressure``
names what ingest does with a full buffer that the policy refuses to
flush: reject the arrival or overwrite the oldest row (ring semantics).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

__all__ = ["FlushPolicy"]


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    #: flush when fill >= ceil(capacity_frac * capacity); None disables
    #: the capacity trigger (deadline/explicit flushes only).
    capacity_frac: Optional[float] = 1.0
    #: flush when the oldest buffered update is older than this (seconds);
    #: None disables the deadline trigger.
    max_delay_s: Optional[float] = None
    #: never flush fewer than this many updates (explicit flushes included).
    min_fill: int = 1
    #: full buffer + no flush: "reject" the arrival or "overwrite" oldest.
    backpressure: str = "reject"

    def __post_init__(self):
        if self.capacity_frac is not None \
                and not 0.0 < self.capacity_frac <= 1.0:
            raise ValueError(f"capacity_frac must be in (0, 1], got "
                             f"{self.capacity_frac}")
        if self.max_delay_s is not None and self.max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got "
                             f"{self.max_delay_s}")
        if self.min_fill < 1:
            raise ValueError(f"min_fill must be >= 1, got {self.min_fill}")
        if self.backpressure not in ("reject", "overwrite"):
            raise ValueError(f"backpressure must be 'reject' or "
                             f"'overwrite', got {self.backpressure!r}")

    def capacity_trigger(self, capacity: int) -> Optional[int]:
        """Fill level at which the capacity trigger fires, or None."""
        if self.capacity_frac is None:
            return None
        return max(self.min_fill,
                   math.ceil(self.capacity_frac * capacity))

    def should_flush(self, fill: int, capacity: int,
                     age_s: float = 0.0) -> bool:
        """Would a buffer at ``fill`` of ``capacity``, whose oldest update
        is ``age_s`` old, flush now?"""
        if fill < self.min_fill:
            return False
        trigger = self.capacity_trigger(capacity)
        if trigger is not None and fill >= trigger:
            return True
        return self.max_delay_s is not None and age_s >= self.max_delay_s
