"""Aggregator registry: one entry per robust center-side aggregation rule
— ``repro/agg/registry.py`` counterpart.

An :class:`Aggregator` bundles the plain PyTorch ``reference`` (the oracle
and the backend on CPU tensors), the ``kernel`` form (a call into the CUDA
order-statistics kernel, or ``None`` when the rule has none: geomedian
couples coordinates), the declared batching rule, and the masked forms
that aggregate the valid prefix of a serving ring buffer
(``repro_torch.agg.masked``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """One robust aggregation rule over the machine axis.

    ``reference(values, *, scale, K, trim_beta, axis)`` -> aggregate with
    the machine axis removed; ``kernel(values, *, scale, K, trim_beta)``
    expects the machine axis at ``-2`` (payload last, leading dims batch)
    and returns ``values.shape`` without the machine axis.
    """
    name: str
    reference: Callable
    kernel: Optional[Callable] = None
    #: "grid"  — coordinate-wise; leading batch axes ride the kernel grid.
    #: "vmap"  — not coordinate-wise; batch via an outer vmap of reference.
    batching: str = "grid"
    #: ``masked(values, fill, *, scale, K, trim_beta)``: the partial-fill
    #: form over a ``(C, p)`` buffer whose first ``fill`` rows are valid.
    #: ``None``: the rule cannot be served from a ring buffer.
    masked: Optional[Callable] = None
    #: the same contract through one order-statistics kernel call on the
    #: prefix (the reference's sort-free "bisect" form); ``None``: none.
    masked_bisect: Optional[Callable] = None
    #: True when the rule consumes a per-coordinate scale (protocol DCQ).
    needs_scale: bool = False
    #: coordinate-wise rules commute with payload sharding (dist/)
    coordinatewise: bool = True
    doc: str = ""


_REGISTRY: Dict[str, Aggregator] = {}


def register(agg: Aggregator) -> Aggregator:
    """Register (or replace) an aggregator under ``agg.name``."""
    if agg.batching not in ("grid", "vmap"):
        raise ValueError(f"unknown batching rule {agg.batching!r}")
    _REGISTRY[agg.name] = agg
    return agg


def get_aggregator(name: str) -> Aggregator:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered() -> Tuple[str, ...]:
    """Names of all registered aggregators, sorted."""
    return tuple(sorted(_REGISTRY))



def has_masked(name: str) -> bool:
    """Whether the rule has a masked partial-fill form (is servable)."""
    return get_aggregator(name).masked is not None
