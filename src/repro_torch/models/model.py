"""Top-level model (``repro/models/model.py`` counterpart): embedding ->
block stack -> LM head, and its serve path.

  Model(cfg, device=None, generator=None)   the parameters (``init``)
  init_cache(batch, max_len) -> cache
  decode_step(cache, batch) -> (logits, cache)   serve path

Dense family only so far; ``forward``/``loss`` (prefill and training) and
the moe, hybrid, ssm, vlm and audio families wait for later slices (ROADMAP
A11). The reference's layer ``scan`` is a Python loop over an
``nn.ModuleList``; its trace-time probe flags (``models/modes.py``, for the
TPU dry-run) have no counterpart.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import _init, embed_init, rms_norm


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class Model(nn.Module):
    """The parameters of ``cfg``, drawn from ``generator`` (a fresh one
    seeded with 0 on ``device`` when None) in ``cfg.dtype``: ``embed``
    (V, d), ``lm_head`` (d, V) unless tied, ``norm_f`` (d,) and
    ``layers``, one ``DenseBlock`` per layer. On the ``meta`` device only
    the shapes are made. ``device`` defaults to the card
    (``repro_torch.resolve_device``)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; only the dense "
                f"family's decode path is (ROADMAP A11)")
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        dt = torch_dtype(cfg)
        kw = dict(generator=generator, dtype=dt, device=dev)
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                              device=dev))
        self.embed = nn.Parameter(embed_init(cfg.vocab, cfg.d_model, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(_init((cfg.d_model, cfg.vocab),
                                              scale=0.02, **kw))
        self.layers = nn.ModuleList(blocks.DenseBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, max_len: int) -> Dict:
        """``{"pos": 0, "attn": {"k": ..., "v": ...}}`` with k and v
        (L, batch, Smax, Hkv, dh) zeros in the model's dtype (the kernel
        takes q and the cache alike), Smax = min(max_len, window) for a
        sliding window (a ring buffer), else max_len. ``pos`` is a Python
        int: the next token's absolute position."""
        cfg = self.cfg
        dt = self.embed.dtype
        win = cfg.sliding_window
        attn_len = min(max_len, win) if win > 0 else max_len
        shape = (cfg.n_layers, batch, attn_len, cfg.n_kv_heads, cfg.head_dim)
        dev = self.embed.device
        return {"pos": 0,
                "attn": {"k": torch.zeros(shape, dtype=dt, device=dev),
                         "v": torch.zeros(shape, dtype=dt, device=dev)}}

    # ------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, cache: Dict, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict]:
        """One-token step. ``batch["tokens"]``: (B, 1) integer ids.
        Returns (logits (B, 1, V), cache): the K/V of the token are written
        into ``cache`` in place and ``cache["pos"]`` is advanced, where the
        reference returns a new cache."""
        cfg = self.cfg
        pos = cache["pos"]
        h = self.embed[batch["tokens"]]                  # (B, 1, d)
        ks, vs = cache["attn"]["k"], cache["attn"]["v"]
        for i, layer in enumerate(self.layers):
            h, _ = blocks.dense_block_decode(layer, h,
                                             {"k": ks[i], "v": vs[i]}, pos,
                                             cfg)
        h = rms_norm(h, self.norm_f, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = h @ head
        cache["pos"] = pos + 1
        return logits, cache
