"""Block wiring (``repro/models/blocks.py`` counterpart): the dense block,
its full-sequence forward and its one-token decode. The other families'
blocks wait for their slices (ROADMAP A11).

A block's parameters are reached by attribute (``p.norm1``,
``p.attn.w_q``, ``p.mlp.w_gate``): :func:`layer_view` of the model's
stacked tree, whose leaves are views of slice i of the stacked tensors.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.layers import rms_norm, swiglu


def layer_view(layers: Mapping, i: int) -> SimpleNamespace:
    """Layer i of a stacked ``layers`` tree (``{attn: {...}, mlp: {...},
    norm1, norm2}``, every leaf with a leading L axis) as attributes: each
    leaf is the view ``leaf[i]``, so gradients through it reach the
    stacked tensor and nothing is copied."""
    def view(node):
        if isinstance(node, Mapping):
            return SimpleNamespace(**{k: view(v) for k, v in node.items()})
        return node[i]
    return view(layers)


def dense_block(p, h: torch.Tensor, cfg: ModelConfig,
                window: int = 0) -> torch.Tensor:
    """Pre-norm attention and SwiGLU MLP over a full sequence h (B, S, d)."""
    h = h + attention.attn_forward(p.attn, rms_norm(h, p.norm1, cfg.norm_eps),
                                   cfg, window=window)
    x = rms_norm(h, p.norm2, cfg.norm_eps)
    return h + swiglu(x, p.mlp.w_gate, p.mlp.w_up, p.mlp.w_down)


def dense_block_decode(p, h: torch.Tensor,
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
