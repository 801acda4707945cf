"""Shared neural building blocks (``repro/models/layers.py`` counterpart).

Weights keep the reference's layout — matrices are ``(fan_in, fan_out)``
and applied as ``x @ W`` — so carrying the reference's parameters across is
a copy. Draws come from a ``torch.Generator`` with the reference's scales;
the numbers differ from ``jax.random``'s, so a test that needs both sides
to hold the same weights carries them across
(``repro_torch.interop.params_from_reference``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.nn import functional as F


def _init(shape, *, generator=None, scale=None, dtype=torch.float32,
          device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 and cast to ``dtype``; ``scale``
    defaults to ``1/sqrt(fan_in)``. On the ``meta`` device only the shape
    is made."""
    dev = torch.device("cpu" if device is None else device)
    if dev.type == "meta":
        return torch.empty(shape, dtype=dtype, device=dev)
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=dev).mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMS norm computed in f32, returned in x's dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.to(torch.float32)).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x @ gate) * (x @ up) )."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mlp_init(d_model: int, d_ff: int, *, generator=None,
             dtype=torch.float32, device=None) -> dict:
    """A SwiGLU MLP's ``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d),
    drawn in this order."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {"w_gate": _init((d_model, d_ff), **kw),
            "w_up": _init((d_model, d_ff), **kw),
            "w_down": _init((d_ff, d_model), **kw)}


def embed_init(vocab: int, d_model: int, *, generator=None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return _init((vocab, d_model), generator=generator, scale=0.02,
                 dtype=dtype, device=device)


def rope_frequencies(d_head: int, theta: float = 1e4,
                     device=None) -> torch.Tensor:
    # a tensor divisor: PyTorch turns a division of a CUDA tensor by a
    # Python scalar into a reciprocal multiply
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) \
        / torch.full((), float(d_head), device=device)
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., seq, heads, d_head); positions: (..., seq). Rotates the
    two halves of d_head in f32, returned in x's dtype."""
    d_head = x.shape[-1]
    freqs = rope_frequencies(d_head, theta, x.device)        # (d_head/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs
    angles = angles[..., None, :]                            # (..., S, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross entropy over (batch, seq[, heads]) in f32, with an
    optional validity mask (the mean over the valid positions)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
