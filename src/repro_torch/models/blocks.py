"""Block wiring for the dense, moe, hybrid and ssm families
(``repro/models/blocks.py`` counterpart): each block's full-sequence
forward and its one-token decode, and the xLSTM block's init.

A block's parameters are reached by attribute (``p.norm1``,
``p.attn.w_q``, ``p.mlp.w_gate``): :func:`layer_view` of a stacked tree
(dense, moe, the hybrid's mamba layers), whose leaves are views of slice i
of the stacked tensors, or :func:`tree_view` of an unstacked one (an
xLSTM layer, the hybrid's shared attention block).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Mapping, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, moe, ssm, xlstm
from repro_torch.models.layers import rms_norm, swiglu


def _view(node, i):
    if isinstance(node, Mapping):
        return SimpleNamespace(**{k: _view(v, i) for k, v in node.items()})
    return node if i is None else node[i]


def layer_view(layers: Mapping, i: int) -> SimpleNamespace:
    """Layer i of a stacked ``layers`` tree (``{attn: {...}, mlp: {...},
    norm1, norm2}``, every leaf with a leading L axis) as attributes: each
    leaf is the view ``leaf[i]``, so gradients through it reach the
    stacked tensor and nothing is copied."""
    return _view(layers, i)


def tree_view(tree: Mapping) -> SimpleNamespace:
    """An unstacked parameter tree (one xLSTM layer, the shared attention
    block) as attributes, each leaf the tensor itself."""
    return _view(tree, None)


def xlstm_block_init(cfg: ModelConfig, layer: int, *, generator=None,
                     dtype=torch.float32, device=None) -> Dict:
    """Layer ``layer`` of an xLSTM stack: ``{norm, mixer}``, the mixer an
    sLSTM where ``layer`` is in ``cfg.slstm_at``, else an mLSTM."""
    init = xlstm.slstm_init if layer in cfg.slstm_at else xlstm.mlstm_init
    return {"norm": torch.ones(cfg.d_model, dtype=dtype, device=device),
            "mixer": init(cfg, generator=generator, dtype=dtype,
                          device=device)}


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


def moe_block(p, h: torch.Tensor, cfg: ModelConfig, window: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention and the MoE FFN over a full sequence; returns (h, the
    layer's aux loss)."""
    h = h + attention.attn_forward(p.attn, rms_norm(h, p.norm1, cfg.norm_eps),
                                   cfg, window=window)
    y, stats = moe.moe_ffn(p.moe, rms_norm(h, p.norm2, cfg.norm_eps), cfg)
    return h + y, stats["aux_loss"]


def mamba_block(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return h + ssm.ssm_forward(p.ssm, rms_norm(h, p.norm, cfg.norm_eps), cfg)


def shared_attn_block(p, h: torch.Tensor, cfg: ModelConfig,
                      window: int = 0) -> torch.Tensor:
    """zamba2's shared-weight attention and MLP block: the dense block's
    wiring on its one weight set."""
    return dense_block(p, h, cfg, window=window)


def moe_block_decode(p, h: torch.Tensor, cache: Dict[str, torch.Tensor],
                     pos: int, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step of a moe block; writes the layer's cache in place."""
    a, cache = attention.attn_decode(p.attn, rms_norm(h, p.norm1, cfg.norm_eps),
                                     cache, pos, cfg)
    h = h + a
    y, _ = moe.moe_ffn(p.moe, rms_norm(h, p.norm2, cfg.norm_eps), cfg)
    return h + y, cache


def mamba_block_decode(p, h: torch.Tensor, cache: Dict[str, torch.Tensor],
                       cfg: ModelConfig
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step of a mamba block; returns a new layer cache."""
    y, cache = ssm.ssm_decode(p.ssm, rms_norm(h, p.norm, cfg.norm_eps),
                              cache, cfg)
    return h + y, cache


def shared_attn_block_decode(p, h: torch.Tensor,
                             cache: Dict[str, torch.Tensor], pos: int,
                             cfg: ModelConfig
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token step of the shared block; writes the insertion's cache in
    place."""
    return dense_block_decode(p, h, cache, pos, cfg)
