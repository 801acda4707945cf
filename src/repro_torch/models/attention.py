"""GQA attention layer: weights, full-sequence attention (train and
prefill) and decode with a KV cache (``repro/models/attention.py``
counterpart).

``p`` is one layer's ``w_q`` (d, Hq*dh), ``w_k``/``w_v`` (d, Hkv*dh) and
``w_o`` (Hq*dh, d), reached by attribute (``blocks.layer_view``): the
reference's fused layout, applied as ``x @ W``. The KV cache of all layers
is allocated at once by ``Model.init_cache`` (the reference's
``attn_cache_init`` broadcast over the layer axis); ``attn_decode`` takes
one layer's ``{"k", "v"}`` views.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import flash
from repro_torch.models.layers import _init, apply_rope


def attn_init(cfg: ModelConfig, *, generator=None, dtype=torch.float32,
              device=None, d_in: int = 0) -> Dict[str, torch.Tensor]:
    """One layer's ``w_q``, ``w_k``, ``w_v`` (``d_in``, default d_model,
    by the heads' width) and ``w_o`` (to d_model), drawn in this order."""
    d, dh = d_in or cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    kw = dict(generator=generator, dtype=dtype, device=device)
    return {"w_q": _init((d, hq), **kw), "w_k": _init((d, hkv), **kw),
            "w_v": _init((d, hkv), **kw),
            "w_o": _init((hq, cfg.d_model), **kw)}


def _project_qkv(p, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    dh = cfg.head_dim
    q = (x @ p.w_q).reshape(B, S, cfg.n_heads, dh)
    k = (x @ p.w_k).reshape(B, S, cfg.n_kv_heads, dh)
    v = (x @ p.w_v).reshape(B, S, cfg.n_kv_heads, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(p, x: torch.Tensor, cfg: ModelConfig,
                 window: int = 0, scale=None) -> torch.Tensor:
    """Full-sequence causal attention (train / prefill). x: (B, S, d_in);
    ``p`` holds one layer's ``w_q``/``w_k``/``w_v``/``w_o``; ``scale``
    is the softmax's, default 1 / sqrt(head_dim)."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, positions, cfg)
    out = flash.flash_attention(q, k, v, causal=True, window=window,
                                scale=scale)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return out @ p.w_o


def attn_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B, 1, d); ``pos``: the absolute position, a
    Python int (no host sync to find the slot).

    Writes this token's K and V into slot ``pos % Smax`` of ``cache`` IN
    PLACE (the reference returns a new cache) and returns (output
    (B, 1, d), cache). Ring-buffer indexing when the cache is shorter than
    the absolute position (sliding window).
    """
    B = x.shape[0]
    smax = cache["k"].shape[1]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, positions, cfg)
    slot = pos % smax
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    cache_len = torch.full((B,), min(pos + 1, smax), dtype=torch.int32,
                           device=x.device)
    out = flash.decode_attention(q, cache["k"], cache["v"], cache_len)
    out = out.reshape(B, 1, cfg.n_heads * cfg.head_dim)
    return out @ p.w_o, cache
