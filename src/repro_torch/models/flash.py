"""Attention for the model (``repro/models/flash.py`` counterpart):
full-sequence attention for training and prefill, its plain oracle, and
the one-token decode.

Shapes: q (B, S, Hq, Dh); k, v (B, T, Hkv, Dh), Hq a multiple of Hkv (GQA:
query head h reads kv head h // (Hq / Hkv)). Output (B, S, Hq, Dh).

``flash_attention`` is plain jnp in the reference (an online softmax over
query and key chunks, never holding the S x T scores); here it is one
``scaled_dot_product_attention`` call, whose fused backends do the same
on the card. The reference rounds the probabilities to V's dtype before
the PV product; the fused kernels keep them in f32. The two agree in f32
and differ at bf16 rounding in bf16 (``tests/test_torch_train.py`` states
the tolerance).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from repro_torch.kernels import gqa_decode as _gqa


NEG_INF = -1e30


def _mask(S: int, T: int, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    """(S, T) boolean: query i (absolute position q_offset + i) may read
    key j."""
    q_pos = q_offset + torch.arange(S, device=device)
    k_pos = torch.arange(T, device=device)
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention in q's dtype through
    ``scaled_dot_product_attention`` (GQA by ``enable_gqa``). ``causal``
    masks keys after the query (query position = ``q_offset`` + index);
    ``window`` > 0 keeps keys in (i - window, i]. Plain causal attention
    is SDPA's ``is_causal``, which the fused backends take without a
    mask; a window or an offset passes an explicit boolean mask.
    ``q_chunk``/``kv_chunk`` (the reference's scan tiles) are accepted and
    unused: the fused backends choose their own tiles."""
    del q_chunk, kv_chunk
    S, T = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))     # (B, H, S, D)
    plain = causal and window <= 0 and q_offset == 0 and S == T
    mask = None if plain or not (causal or window > 0) else \
        _mask(S, T, causal, window, q_offset, q.device)
    out = F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=plain, scale=scale,
        enable_gqa=q.shape[2] != k.shape[2])
    return out.transpose(1, 2)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        q_offset: int = 0,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Naive O(S*T) attention, the oracle for tests (small shapes only):
    scores in f32, the probabilities rounded to V's dtype before PV, as the
    reference's oracle does."""
    B, S, Hq, Dh = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    kk = k.repeat_interleave(groups, dim=2)
    vv = v.repeat_interleave(groups, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q, kk).to(torch.float32) * scale
    mask = _mask(S, T, causal, window, q_offset, q.device)
    s = s.masked_fill(~mask[None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p.to(vv.dtype), vv)


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
