"""Attention kernels' entry for the model (``repro/models/flash.py``
counterpart): the one-token decode. ``flash_attention`` and
``attention_reference`` (train and prefill) wait for a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gqa_decode as _gqa


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """One-token decode: q (B, 1, Hq, Dh) vs cache (B, Smax, Hkv, Dh), the
    first ``cache_len[b]`` slots valid; returns (B, 1, Hq, Dh) in q's dtype.

    For ring-buffer (sliding-window) caches the caller passes
    ``cache_len = min(pos+1, Smax)``; softmax is permutation-invariant, so
    ring order needs no unwinding. Runs the GQA flash-decode kernel (its
    plain version on CPU tensors). Unlike the reference's jnp form, which
    rounds the probabilities to the cache's dtype before the PV product,
    the kernel keeps them in f32: the two agree in f32 and differ at bf16
    rounding in bf16.
    """
    B, _, Hq, Dh = q.shape
    out = _gqa.gqa_decode(q.reshape(B, Hq, Dh), k_cache, v_cache, cache_len)
    return out.reshape(B, 1, Hq, Dh)
