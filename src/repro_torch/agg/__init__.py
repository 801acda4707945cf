"""``repro_torch.agg`` — robust aggregation over the machine axis
(``repro.agg`` counterpart).

* :mod:`repro_torch.agg.registry`  — the six built-in rules, each a plain
  PyTorch reference plus, where the rule has one, a kernel form.
* :mod:`repro_torch.agg.reference` — the plain PyTorch oracles.
* :mod:`repro_torch.agg.kernel`    — the CUDA order-statistics kernel
  (``csrc/ostat.cu``), its wrapper and its plain version.
* :mod:`repro_torch.agg.masked`    — the masked partial-fill forms that
  serve a ring buffer's valid prefix (``aggregate_masked``).

* :mod:`repro_torch.agg.dispatch`  — the measured backend-dispatch table
  (``tables/cuda.json``, tuned on the card by
  :mod:`repro_torch.agg.autotune`).

Backend selection: ``backend=None`` consults the measured dispatch table
of the tensor's platform (:func:`dispatch.decide`) under the problem's
shape bucket: ``aggregate`` at ``(1, m, prod(payload))``,
``aggregate_batched`` at ``(prod(batch), m, p)``, ``median_mad_dcq``
under op ``"median_mad_dcq"`` and ``aggregate_masked`` under op
``masked:<rule>`` at ``(1, capacity, prod(payload))``. A measured bucket
runs its recorded best backend with its recorded kernel parameters
(``lanes``); an unmeasured one, or one with no table for the platform,
runs the platform rule: the kernel (``"bisect"`` where the rule has a
bisect form) at its planner's lanes on a CUDA tensor, the reference
(``"sort"``) on a CPU tensor. On a CUDA tensor every decision is B1: the
card's table chooses only its launch parameters, and plain PyTorch never
stands in for the kernel there. A kernel that fails raises, and is never
retried on another backend. ``backend="kernel"`` forces the wrapper (on a
CPU tensor that is the kernel's plain version); ``backend="reference"``
forces the oracle. Rules without a kernel form (geomedian) always run
their reference, and masked rules without a bisect form their sort,
without a decision.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.agg import dispatch, kernel, masked, reference
from repro_torch.agg.dispatch import DispatchTable
from repro_torch.agg.kernel import OPS, cq_constants, ostat, ostat_plain
from repro_torch.agg.reference import (ARE_MEDIAN, are_dcq, d_k, dcq,
                                       dcq_mad_reference, dcq_with_sigma,
                                       geometric_median_agg, mean_agg,
                                       median_agg, median_deviation_variance,
                                       median_mad_dcq_reference,
                                       quantile_knots, quantile_levels,
                                       trimmed_mean_agg)
from repro_torch.agg.registry import (Aggregator, get_aggregator,
                                      has_masked, register, registered)

__all__ = [
    "Aggregator", "register", "get_aggregator", "registered", "has_masked",
    "dispatch", "DispatchTable",
    "aggregate", "aggregate_batched", "aggregate_masked", "median_mad_dcq",
    "median_deviation_variance", "ostat", "ostat_plain", "OPS",
    "cq_constants", "dcq", "dcq_with_sigma", "dcq_mad_reference",
    "median_mad_dcq_reference", "quantile_levels", "quantile_knots",
    "d_k", "are_dcq", "ARE_MEDIAN", "mean_agg", "median_agg",
    "trimmed_mean_agg", "geometric_median_agg", "kernel", "masked",
    "reference",
]


# ----------------------------------------------------- built-in aggregators
#
# reference signature: (values, *, scale, K, trim_beta, axis) -> aggregate
# kernel signature:    (values, *, scale, K, trim_beta) with the machine
#                      axis at -2, leading dims batch.

def _kernel_op(op):
    def run(values, *, scale=None, K=10, trim_beta=0.2, lanes=None):
        return ostat(values, op, scale, K=K, trim_beta=trim_beta,
                     lanes=lanes)
    return run


register(Aggregator(
    name="mean",
    reference=lambda values, *, scale=None, K=10, trim_beta=0.2, axis=0:
        reference.mean_agg(values, axis=axis),
    kernel=_kernel_op("mean"), masked=masked.masked_mean,
    doc="non-robust average (the efficiency yardstick)"))

register(Aggregator(
    name="median",
    reference=lambda values, *, scale=None, K=10, trim_beta=0.2, axis=0:
        reference.median_agg(values, axis=axis),
    kernel=_kernel_op("median"), masked=masked.masked_median,
    masked_bisect=masked.masked_median_bisect,
    doc="coordinate-wise median (Yin et al. 2018)"))

register(Aggregator(
    name="trimmed",
    reference=lambda values, *, scale=None, K=10, trim_beta=0.2, axis=0:
        reference.trimmed_mean_agg(values, beta=trim_beta, axis=axis),
    kernel=_kernel_op("trimmed"), masked=masked.masked_trimmed,
    doc="coordinate-wise beta-trimmed mean (Yin et al. 2018/19)"))

register(Aggregator(
    name="geomedian",
    reference=lambda values, *, scale=None, K=10, trim_beta=0.2, axis=0:
        reference.geometric_median_agg(values, axis=axis),
    kernel=None, batching="vmap", coordinatewise=False,
    masked=masked.masked_geomedian,
    doc="geometric median via Weiszfeld (Chen et al. 2017); couples "
        "coordinates, so no kernel form"))

register(Aggregator(
    name="dcq",
    reference=lambda values, *, scale=None, K=10, trim_beta=0.2, axis=0:
        reference.dcq(values, scale, K=K, axis=axis),
    kernel=_kernel_op("dcq"), needs_scale=True, masked=masked.masked_dcq,
    masked_bisect=masked.masked_dcq_bisect,
    doc="the paper's composite-quantile estimator with oracle scale "
        "(§3/§4.4)"))

register(Aggregator(
    name="dcq_mad",
    reference=lambda values, *, scale=None, K=10, trim_beta=0.2, axis=0:
        reference.dcq_mad_reference(values, K=K, axis=axis),
    kernel=_kernel_op("dcq_mad"), masked=masked.masked_dcq_mad,
    masked_bisect=masked.masked_dcq_mad_bisect,
    doc="MAD-self-calibrated DCQ (the gradient-aggregation path, no "
        "transmitted variance)"))


# ------------------------------------------------------------ dispatch API

def _pick_backend(agg: Aggregator, backend: Optional[str],
                  values: torch.Tensor, shape) -> "tuple[str, dict]":
    """Resolve the backend of one ``(B, m, p)`` problem: (backend,
    kernel params). ``backend=None`` consults the dispatch table of
    ``values``' platform; params are empty for a forced backend."""
    if agg.kernel is None:                 # e.g. geomedian: no kernel form
        backend = backend or "reference"
    elif backend is None:
        dec = dispatch.decide(agg.name, *shape,
                              platform=values.device.type)
        return dec.backend, dict(dec.params)
    if backend not in ("kernel", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    return ("reference" if agg.kernel is None else backend), {}


def _as_scale(scale, payload, like: torch.Tensor) -> torch.Tensor:
    """A scale (number or tensor broadcastable to ``payload``) as a
    contiguous tensor of shape ``payload``."""
    # repro-torch: allow(step-sync) — a device scale passes through uncopied;
    # only a host number is copied to the card (the scale of dcq)
    return torch.as_tensor(scale, dtype=like.dtype, device=like.device) \
        .broadcast_to(payload).contiguous()


def aggregate(values: torch.Tensor, method: str = "dcq", scale=None,
              K: int = 10, trim_beta: float = 0.2, axis: int = 0,
              backend: Optional[str] = None) -> torch.Tensor:
    """Aggregate ``values`` over its machine axis with a registered rule.

    Returns ``values.shape`` without ``axis``. ``backend=None`` decides at
    ``(1, m, prod(payload))``. On the kernel backend the payload is
    flattened to one row of coordinates: one launch.
    """
    agg = get_aggregator(method)
    if agg.needs_scale and scale is None:
        raise ValueError(f"{method!r} needs a per-coordinate scale")
    vals = values.movedim(axis, 0)                     # (m, *payload)
    payload = vals.shape[1:]
    be, params = _pick_backend(agg, backend, values,
                               (1, vals.shape[0], math.prod(payload)))
    if be == "reference":
        return agg.reference(values, scale=scale, K=K, trim_beta=trim_beta,
                             axis=axis)
    flat = vals.reshape(vals.shape[0], -1)
    sc = None if scale is None else _as_scale(scale, payload, values) \
        .reshape(-1)
    out = agg.kernel(flat, scale=sc, K=K, trim_beta=trim_beta, **params)
    return out.reshape(payload).to(values.dtype)


def aggregate_masked(values: torch.Tensor, fill: int, method: str = "dcq",
                     scale=None, K: int = 10, trim_beta: float = 0.2,
                     axis: int = 0,
                     backend: Optional[str] = None) -> torch.Tensor:
    """Partial-fill aggregation over a fixed-capacity buffer: reduce the
    first ``fill`` rows of the machine axis (a host int in [1, C]) and
    never read the stale tail, so the result equals this same call on the
    dense ``values[:fill]`` byte for byte.

    ``backend``: ``"sort"`` (the rule's plain reference on the prefix:
    ``median`` is bit-equal to the registry reference at every fill),
    ``"bisect"`` (one order-statistics call on the prefix: the kernel on a
    CUDA tensor) or None: the dispatch table under op ``masked:<method>``
    at ``(1, capacity, prod(payload))`` for a rule with a bisect form
    (median, dcq, dcq_mad; on a CUDA tensor always bisect, at the lanes
    the table measured), sort for the others. Returns ``values.shape``
    without ``axis``, in ``values.dtype``.
    """
    agg = get_aggregator(method)
    if agg.masked is None:
        raise ValueError(f"{method!r} has no masked partial-fill form; "
                         f"servable rules: "
                         f"{[n for n in registered() if has_masked(n)]}")
    if agg.needs_scale and scale is None:
        raise ValueError(f"{method!r} needs a per-coordinate scale")
    vals = values.movedim(axis, 0)                 # (C, *payload)
    payload = vals.shape[1:]
    params: dict = {}
    if backend is None:
        backend = "sort"
        if agg.masked_bisect is not None:
            dec = dispatch.decide(
                f"masked:{method}", 1, vals.shape[0], math.prod(payload),
                platform=values.device.type)
            backend, params = dec.backend, dict(dec.params)
    if backend == "bisect":
        if agg.masked_bisect is None:
            bisect = [n for n in registered()
                      if get_aggregator(n).masked_bisect is not None]
            raise ValueError(f"{method!r} has no bisect masked form; "
                             f"bisect rules: {bisect}")
        fn = agg.masked_bisect
    elif backend == "sort":
        fn = agg.masked
    else:
        raise ValueError(f"unknown masked backend {backend!r} "
                         "(one of 'sort', 'bisect')")
    flat = vals.reshape(vals.shape[0], -1)
    sc = None if scale is None else _as_scale(scale, payload, vals) \
        .reshape(-1)
    out = fn(flat, fill, scale=sc, K=K, trim_beta=trim_beta, **params)
    return out.reshape(payload).to(values.dtype)


def aggregate_batched(values: torch.Tensor, method: str = "dcq", scale=None,
                      K: int = 10, trim_beta: float = 0.2,
                      backend: Optional[str] = None) -> torch.Tensor:
    """Batched aggregation ``(*B, m, p) -> (*B, p)`` (machine axis at -2).

    ``backend=None`` decides at ``(prod(B), m, p)``. Grid rules push the
    whole batch through ONE kernel launch; ``"vmap"`` rules (geomedian)
    batch their reference with ``torch.func.vmap``; the coordinate-wise
    references batch natively over ``axis=-2``.
    """
    agg = get_aggregator(method)
    if agg.needs_scale and scale is None:
        raise ValueError(f"{method!r} needs a per-coordinate scale")
    if values.dim() < 2:
        raise ValueError(f"need (*batch, m, p), got {tuple(values.shape)}")
    be, params = _pick_backend(agg, backend, values,
                               (math.prod(values.shape[:-2]),)
                               + tuple(values.shape[-2:]))
    if scale is not None:
        scale = _as_scale(scale, values.shape[:-2] + values.shape[-1:],
                          values)
    if be == "kernel":
        out = agg.kernel(values, scale=scale, K=K, trim_beta=trim_beta,
                         **params)
        return out.to(values.dtype)
    if agg.batching == "vmap" and values.dim() > 2:
        m, p = values.shape[-2:]
        flat = values.reshape((-1, m, p))
        out = torch.func.vmap(lambda v: agg.reference(
            v, scale=None, K=K, trim_beta=trim_beta, axis=0))(flat)
        return out.reshape(values.shape[:-2] + (p,))
    return agg.reference(values, scale=scale, K=K, trim_beta=trim_beta,
                         axis=-2)


def median_mad_dcq(values: torch.Tensor, K: int = 10,
                   backend: Optional[str] = None):
    """Fused ``(median, raw MAD, MAD-scaled DCQ)`` over the machine axis at
    -2 (leading dims batch): one kernel launch on the kernel backend.
    ``backend=None`` decides under op ``"median_mad_dcq"``."""
    params: dict = {}
    if backend is None and values.dim() >= 2:
        shape = (math.prod(values.shape[:-2]),) + tuple(values.shape[-2:])
        dec = dispatch.decide("median_mad_dcq", *shape,
                              platform=values.device.type)
        backend, params = dec.backend, dict(dec.params)
    if backend is None:
        backend = "kernel" if values.is_cuda else "reference"
    if backend == "kernel":
        return ostat(values, "median_mad_dcq", K=K, **params)
    if backend != "reference":
        raise ValueError(f"unknown backend {backend!r}")
    return reference.median_mad_dcq_reference(values, K=K, axis=-2)
