"""Block wiring for the dense, moe, hybrid and ssm families
(``repro/models/blocks.py`` counterpart): each block's full-sequence
forward and its one-token decode, and the xLSTM block's init.

A block's parameters are reached by attribute (``p.norm1``,
``p.attn.w_q``, ``p.mlp.w_gate``): :func:`layer_view` of a stacked tree
(dense, moe, the hybrid's mamba layers), whose leaves are views of slice i
of the stacked tensors, or :func:`tree_view` of an unstacked one (an
xLSTM layer, the hybrid's shared attention block).

Under a payload sharding (``dist.payload``, the step's
``core.transport.active_payload``) a rank holds the slice of every leaf
sharded over the mesh's "model" axis: the two views then hold such a leaf
as a :class:`Shard`, and :func:`full` gathers it over the model group.
The model calls :func:`full` inside each layer's rematerialised region,
so a layer's gathered weights live only while the layer runs, and this
is the one place the port turns slices into weights (training, prefill
and decode alike).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Mapping, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.transport import active_payload
from repro_torch.models import attention, moe, ssm, xlstm
from repro_torch.models.layers import _init, rms_norm, swiglu


class Shard:
    """A leaf's slice on this rank, waiting for :func:`full` to gather
    it: ``x`` the slice, ``path`` the leaf's name in the parameter
    tree."""
    __slots__ = ("x", "path", "payload")

    def __init__(self, x: torch.Tensor, path: str, payload):
        self.x, self.path, self.payload = x, path, payload


def _view(node, i, path: str, pl):
    if isinstance(node, Mapping):
        return SimpleNamespace(**{k: _view(v, i, f"{path}/{k}", pl)
                                  for k, v in node.items()})
    x = node if i is None else node[i]
    if pl is not None and pl.by_path.get(path) is not None:
        return Shard(x, path, pl)
    return x


def layer_view(layers: Mapping, i: int,
               prefix: str = "layers") -> SimpleNamespace:
    """Layer i of a stacked ``layers`` tree (``{attn: {...}, mlp: {...},
    norm1, norm2}``, every leaf with a leading L axis) as attributes: each
    leaf is the view ``leaf[i]``, so gradients through it reach the
    stacked tensor and nothing is copied. ``prefix`` is the tree's path
    in the parameters (a sharded leaf is a :class:`Shard`)."""
    return _view(layers, i, prefix, active_payload())


def tree_view(tree: Mapping, prefix: str = "") -> SimpleNamespace:
    """An unstacked parameter tree (one xLSTM layer, the shared attention
    block) as attributes, each leaf the tensor itself; ``prefix`` as in
    :func:`layer_view`."""
    return _view(tree, None, prefix, active_payload())


def full(p):
    """A view with every :class:`Shard` gathered over the model group
    (``p`` itself where it holds none)."""
    if isinstance(p, Shard):
        return p.payload.gather(p.x, p.path)
    if isinstance(p, SimpleNamespace):
        kids = vars(p)
        out = {k: full(v) for k, v in kids.items()}
        if all(out[k] is kids[k] for k in kids):
            return p
        return SimpleNamespace(**out)
    return p


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


def zamba2_shared_init(cfg, *, generator=None, dtype=torch.float32,
                       device=None) -> Dict:
    """One shared block of Zamba2 as published: ``norm1`` (2d,), ``attn``
    (``w_q``/``w_k``/``w_v`` from 2d, ``w_o`` to d), ``norm2`` (d,) and
    ``mlp/{w_gate_up (d, 2f), w_down (f, d)}``, drawn in this order."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    d, f = cfg.d_model, cfg.d_ff
    return {"norm1": torch.ones(2 * d, dtype=dtype, device=device),
            "attn": attention.attn_init(cfg, d_in=2 * d, **kw),
            "norm2": torch.ones(d, dtype=dtype, device=device),
            "mlp": {"w_gate_up": _init((d, 2 * f), **kw),
                    "w_down": _init((f, d), **kw)}}


def zamba2_insertion_init(cfg, *, generator=None, dtype=torch.float32,
                          device=None) -> Dict:
    """One insertion's own leaves: the MLP adapter ``adapter_a`` (d, r)
    and ``adapter_b`` (r, 2f), and ``linear`` (d, d), drawn in this
    order."""
    kw = dict(generator=generator, dtype=dtype, device=device)
    d, f, r = cfg.d_model, cfg.d_ff, cfg.adapter_rank
    return {"adapter_a": _init((d, r), **kw),
            "adapter_b": _init((r, 2 * f), **kw),
            "linear": _init((d, d), **kw)}


def zamba2_shared_block(p, ins, h: torch.Tensor, e: torch.Tensor,
                        cfg) -> torch.Tensor:
    """Insertion ``ins`` of shared block ``p`` over the hidden state h and
    the token embedding e (B, S, d): RMS norm of [h ‖ e], attention at
    scale (head_dim / 2) ** -0.5, RMS norm, the GELU-gated MLP with the
    insertion's adapter on ``gate_up``, then the insertion's ``linear``.
    Returns what the next Mamba2 layer adds to its input."""
    x = rms_norm(torch.cat([h, e], dim=-1), p.norm1, cfg.norm_eps)
    a = attention.attn_forward(p.attn, x, cfg,
                               scale=(cfg.head_dim / 2) ** -0.5)
    u = rms_norm(a, p.norm2, cfg.norm_eps)
    gate, up = (u @ p.mlp.w_gate_up
                + (u @ ins.adapter_a) @ ins.adapter_b).chunk(2, dim=-1)
    return ((F.gelu(gate) * up) @ p.mlp.w_down) @ ins.linear


def zamba2_mamba_block(p, h: torch.Tensor, t, cfg) -> torch.Tensor:
    """A Mamba2 layer of Zamba2 as published: the residual h plus the
    mixer of the normed ``h + t``, t the shared block's output where an
    insertion precedes the layer (None elsewhere)."""
    x = h if t is None else h + t
    return h + ssm.ssm_forward(p.ssm, rms_norm(x, p.norm, cfg.norm_eps), cfg)


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
