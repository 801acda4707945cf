"""Block wiring (``repro/models/blocks.py`` counterpart): the dense block
and its one-token decode. The other families' blocks wait for their
slices (ROADMAP A11).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import MLP, rms_norm, swiglu


class DenseBlock(nn.Module):
    """``dense_block_init``: pre-norm attention and SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(generator=generator, dtype=dtype, device=device)
        self.norm1 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                             device=device))
        self.attn = attention.Attention(cfg, **kw)
        self.norm2 = nn.Parameter(torch.ones(cfg.d_model, dtype=dtype,
                                             device=device))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, **kw)


def dense_block_decode(p: DenseBlock, h: torch.Tensor,
                       cache: Dict[str, torch.Tensor], pos: int,
                       cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step of a dense block; writes the layer's cache in place
    (see ``attention.attn_decode``)."""
    a, cache = attention.attn_decode(p.attn, rms_norm(h, p.norm1, cfg.norm_eps),
                                     cache, pos, cfg)
    h = h + a
    x = rms_norm(h, p.norm2, cfg.norm_eps)
    return h + swiglu(x, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down), cache
