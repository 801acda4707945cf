"""Masked partial-fill aggregation: the serving path's numerics —
``repro/agg/masked.py`` counterpart.

A serving ring buffer (``repro_torch.serve``) holds a fixed-capacity
``(C, p)`` stack whose first ``fill`` rows are valid machine updates and
whose tail is stale. A flush must aggregate exactly what the dense
unpadded ``(fill, p)`` batch would: stragglers may shrink the batch, they
must never perturb the estimate.

The reference earns that exactness with two devices: block-sequential
``lax.scan`` sums and parity-balanced ±inf median padding. Both exist
because under ``jax.jit`` the fill is a traced scalar, never a shape, and
XLA's reduction trees depend on shapes. In eager PyTorch the fill is a
host int, and for a contiguous ``(C, d)`` leaf ``values[:fill]`` is itself
a contiguous view. Every form here therefore runs on that prefix view:
the stale tail is never read, so ``masked(buffer, fill=k)`` equals
``masked(buffer[:k], fill=k)`` byte for byte by construction, and neither
device is carried over.

Two forms per rule, as in the reference:

* the "sort" forms (``masked_<rule>``): the rule's plain PyTorch
  reference on the prefix, except where the reference's masked form
  computes differently: ``masked_trimmed`` takes ``g = floor(beta * fill)``
  in the payload dtype, ``masked_geomedian`` starts from the masked median
  (50 Weiszfeld steps, eps 1e-8) and ``masked_dcq_mad`` casts to float32;
* the "bisect" forms (``masked_median_bisect``, ``masked_dcq_bisect``,
  ``masked_dcq_mad_bisect``): ONE order-statistics call on the prefix
  (``kernel.ostat``), which is the CUDA kernel on a CUDA tensor and its
  plain version on a CPU tensor. For an f32 buffer the kernel reads the
  prefix view without a copy, so it needs no fill argument of its own.

Every form takes the machine axis at 0 and a 2-D ``(C, p)`` payload;
``repro_torch.agg.aggregate_masked`` and the wire reshape leaves to that.
"""
from __future__ import annotations

import numbers

import torch

from repro_torch.agg import kernel, reference

__all__ = ["masked_mean", "masked_median", "masked_trimmed",
           "masked_geomedian", "masked_dcq", "masked_dcq_mad",
           "masked_median_bisect", "masked_dcq_bisect",
           "masked_dcq_mad_bisect"]


def _prefix(values: torch.Tensor, fill) -> torch.Tensor:
    """The valid rows ``values[:fill]``; ``fill`` must be a host int in
    [1, C]."""
    if not isinstance(fill, numbers.Integral) or isinstance(fill, bool):
        raise TypeError(f"fill must be a host int, got "
                        f"{type(fill).__name__}")
    C = values.shape[0]
    if not 1 <= fill <= C:
        raise ValueError(f"fill={fill} outside [1, {C}] (the buffer's "
                         f"capacity)")
    return values[:fill]


# ------------------------------------------------------------ sort forms

def masked_mean(values, fill, *, scale=None, K=10, trim_beta=0.2):
    return reference.mean_agg(_prefix(values, fill), 0)


def masked_median(values, fill, *, scale=None, K=10, trim_beta=0.2):
    """Sort-and-average median of the prefix: bit-equal to the registry
    reference (and to ``jnp.median``) at every fill."""
    return reference.median_agg(_prefix(values, fill), 0)


def masked_trimmed(values, fill, *, scale=None, K=10, trim_beta=0.2):
    """beta-trimmed mean of the prefix with ``g = floor(beta * fill)``
    computed in the payload dtype, as the reference's masked form does
    (``int(beta * m)`` in double can differ by one row where ``beta * m``
    lands on an integer). Any beta < 0.5 keeps the window non-empty."""
    if not trim_beta < 0.5:
        raise ValueError(f"trim fraction {trim_beta} too large: the "
                         "masked window must stay non-empty at fill 1")
    vals = _prefix(values, fill)
    g = int(torch.floor(torch.tensor(trim_beta, dtype=vals.dtype)
                        * torch.tensor(fill, dtype=vals.dtype)))
    return vals.sort(dim=0).values[g:fill - g].mean(dim=0)


def masked_geomedian(values, fill, *, scale=None, K=10, trim_beta=0.2,
                     iters: int = 50, eps: float = 1e-8):
    """Weiszfeld over the prefix, from its median, ``iters`` steps."""
    return reference.geometric_median_agg(_prefix(values, fill), 0,
                                          iters=iters, eps=eps)


def masked_dcq(values, fill, *, scale=None, K=10, trim_beta=0.2):
    """DCQ with oracle scale over the prefix."""
    return reference.dcq(_prefix(values, fill), scale, K=K, axis=0)


def masked_dcq_mad(values, fill, *, scale=None, K=10, trim_beta=0.2):
    """MAD-self-calibrated DCQ over the prefix, in float32."""
    return reference.dcq_mad_reference(
        _prefix(values, fill).to(torch.float32), K=K, axis=0)


# ---------------------------------------------------------- bisect forms

def masked_median_bisect(values, fill, *, scale=None, K=10, trim_beta=0.2,
                         lanes=None):
    """The median of the prefix by rank-count bisection: one ``ostat``
    call (the kernel on a CUDA tensor, with ``lanes`` lanes per coordinate
    where given)."""
    return kernel.ostat(_prefix(values, fill), "median", lanes=lanes)


def masked_dcq_bisect(values, fill, *, scale=None, K=10, trim_beta=0.2,
                      lanes=None):
    """DCQ with oracle scale, bisection median anchor: one ``ostat``
    call."""
    return kernel.ostat(_prefix(values, fill), "dcq", scale, K=K,
                        lanes=lanes)


def masked_dcq_mad_bisect(values, fill, *, scale=None, K=10,
                          trim_beta=0.2, lanes=None):
    """MAD-self-calibrated DCQ, both medians by bisection: one ``ostat``
    call, computed in float32."""
    return kernel.ostat(_prefix(values, fill).to(torch.float32), "dcq_mad",
                        K=K, lanes=lanes)
