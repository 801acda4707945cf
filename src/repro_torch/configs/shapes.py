"""Stand-ins for every model input of a shape — ``repro/configs/shapes.py``
counterpart.

``input_specs`` gives meta tensors (shape and dtype, no memory) with the
reference's names, shapes and dtypes for the step a shape exercises:
train and prefill a full-sequence batch, decode a one-token batch and a
cache, which comes from ``Model.init_cache`` on the meta device. The dry
run (``launch.dryrun``) traces on them; ``concrete_batch`` draws a batch
of the same specs from a ``torch.Generator``.

The modality carve-out: audio gives EnCodec codebook token streams; the
vlm gives precomputed vision-tower patch embeddings (the stub frontend),
576 of them, and ``S - 576`` text tokens.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["N_PATCHES_SPEC", "LONG_WINDOW", "adapt_config", "input_specs",
           "concrete_batch"]

N_PATCHES_SPEC = 576   # llava-next base-tile patches

LONG_WINDOW = 4096     # sliding window used by non-SSM archs at 500k

_TOK = torch.int32


def adapt_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """long_500k needs sub-quadratic attention: the dense, moe, vlm and
    audio archs switch to the sliding-window variant; ssm and hybrid run
    natively (the hybrid's shared attention also windows)."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        if cfg.sliding_window == 0:
            return cfg.with_sliding_window(LONG_WINDOW)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``{name: meta tensor}`` for the step ``shape`` exercises.

    train/prefill: the full-sequence batch (``labels`` for train); decode:
    ``tokens`` (B, 1) ((B, 1, n_codebooks) for audio) and ``cache``, the
    adapted config's ``init_cache(B, S)`` on the meta device (its ``pos``
    a Python int; the dry run sets it to S - 1)."""
    from repro_torch.models.model import VISION_DIM, Model
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {}
        if cfg.family == "vlm":
            s_text = S - cfg.n_patches
            batch["tokens"] = _meta((B, s_text), _TOK)
            batch["patch_embeds"] = _meta((B, cfg.n_patches, VISION_DIM),
                                          torch.bfloat16)
            if shape.kind == "train":
                batch["labels"] = _meta((B, s_text), _TOK)
        elif cfg.family == "audio":
            batch["tokens"] = _meta((B, S, cfg.n_codebooks), _TOK)
            if shape.kind == "train":
                batch["labels"] = _meta((B, S), _TOK)
        else:
            batch["tokens"] = _meta((B, S), _TOK)
            if shape.kind == "train":
                batch["labels"] = _meta((B, S), _TOK)
        return batch
    # decode: one new token against a cache of length S
    cfg = adapt_config(cfg, shape)
    cache = Model(cfg, device="meta").init_cache(B, S)
    if cfg.family == "audio":
        tokens = _meta((B, 1, cfg.n_codebooks), _TOK)
    else:
        tokens = _meta((B, 1), _TOK)
    return {"tokens": tokens, "cache": cache}


def concrete_batch(key: torch.Generator, cfg: ModelConfig,
                   shape: ShapeConfig, device=None) -> Dict[str, Any]:
    """A batch matching :func:`input_specs`, drawn from ``key`` on
    ``device`` (default: the generator's): token ids uniform in
    ``[0, vocab)``, the rest standard normals, and for decode a fresh
    cache of the adapted config (``init_cache``'s zeros, made on
    ``device`` from the meta cache: no parameters are drawn), in
    ``input_specs``' order."""
    from repro_torch.core.transport import tree_map
    dev = torch.device(device if device is not None else key.device)
    out: Dict[str, Any] = {}
    for name, spec in input_specs(cfg, shape).items():
        if name == "cache":
            out[name] = tree_map(
                lambda t: torch.zeros(t.shape, dtype=t.dtype, device=dev)
                if isinstance(t, torch.Tensor) else t, spec)
        elif spec.dtype == _TOK:
            out[name] = torch.randint(0, cfg.vocab, spec.shape,
                                      generator=key, dtype=_TOK,
                                      device=dev)
        else:
            out[name] = torch.randn(spec.shape, generator=key,
                                    dtype=spec.dtype, device=dev)
    return out
