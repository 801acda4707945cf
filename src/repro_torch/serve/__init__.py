"""``repro_torch.serve`` — the streaming aggregation service
(``repro.serve`` counterpart).

Machine updates stream in, a fixed-capacity :class:`RingBuffer` on the
device absorbs them with in-place writes, and whenever the
:class:`FlushPolicy` fires (buffer full, deadline, or explicit flush) the
buffered prefix becomes one DP-noised, robustly aggregated model update:

  * :class:`AggregationService` — submit / poll / flush over a model tree
    or a flat parameter vector;
  * :class:`ServeConfig`       — the rule, the DP budget, the learning
    rate, the ingest block;
  * :class:`FlushPolicy`       — when buffered updates become a round;
  * :class:`RingBuffer`        — the ingest buffer.

The masked partial-fill forms live in :mod:`repro_torch.agg.masked`.
"""
from __future__ import annotations

from repro_torch.serve.buffers import RingBuffer
from repro_torch.serve.flush import FlushPolicy
from repro_torch.serve.service import AggregationService, ServeConfig

__all__ = ["AggregationService", "ServeConfig", "FlushPolicy",
           "RingBuffer"]
