"""Aggregator registry: one entry per robust center-side aggregation rule
— ``repro/agg/registry.py`` counterpart.

An :class:`Aggregator` bundles the plain PyTorch ``reference`` (the oracle
and the backend on CPU tensors), the ``kernel`` form (a call into the CUDA
order-statistics kernel, or ``None`` when the rule has none: geomedian
couples coordinates) and the declared batching rule.
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
    #: True when the rule consumes a per-coordinate scale (protocol DCQ).
    needs_scale: bool = False
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

