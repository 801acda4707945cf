"""Synthetic LM data: a Markov token stream with learnable structure —
``repro/data/lm.py`` counterpart, on an explicit ``torch.Generator``.

Each vocab id v prefers the successor (a*v + c) mod V with probability q
and is otherwise followed by a uniform draw, so a small model's loss
drops within tens of steps. The draws are torch's, not ``jax.random``'s;
parity tests hand the reference's tokens across (or its draws to
:func:`markov_chain`).

The reference runs the chain with a ``lax.scan`` over positions. Here it
is vectorised instead of looped (a loop would be ``seq`` launches per
batch on the card): with f(x) = (a x + c) mod V, a token k steps after
the last uniform draw x_j is f^k(x_j) = (a^k x_j + c_k) mod V, with a^k
and c_k mod V tabulated on the host, so a batch is a handful of device
operations and equals the scan exactly.
"""
from __future__ import annotations

from typing import Dict, Iterator

import torch

from repro_torch.configs.base import ModelConfig

A, C = 31, 17


def markov_chain(first: torch.Tensor, flips: torch.Tensor,
                 rand: torch.Tensor, vocab: int, a: int = A,
                 c: int = C) -> torch.Tensor:
    """The chain from its draws: ``first`` (B, 1) ids, ``flips`` (B, S-1)
    booleans (take the preferred successor (a*v + c) mod V), ``rand``
    (B, S-1) uniform ids. Returns (B, S) int64 ids."""
    B, n = flips.shape
    dev = flips.device
    ak, ck, a_k, c_k = [], [], 1, 0
    for _ in range(n + 1):                  # f^k = (a^k x + c_k) mod V
        ak.append(a_k)
        ck.append(c_k)
        a_k, c_k = (a * a_k) % vocab, (a * c_k + c) % vocab
    ak = torch.tensor(ak, dtype=torch.int64, device=dev)
    ck = torch.tensor(ck, dtype=torch.int64, device=dev)
    base = torch.cat([first.long(), rand.long()], dim=1)        # (B, S)
    reset = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                       ~flips.bool()], dim=1)
    pos = torch.arange(n + 1, device=dev).expand(B, n + 1)
    last = torch.where(reset, pos, torch.zeros_like(pos)).cummax(dim=1) \
        .values                              # the last uniform draw
    k = pos - last
    return (ak[k] * torch.gather(base, 1, last) + ck[k]) % vocab


def markov_tokens(generator: torch.Generator, batch: int, seq: int,
                  vocab: int, q: float = 0.8) -> torch.Tensor:
    """(batch, seq) int64 ids on the generator's device."""
    kw = dict(generator=generator, device=generator.device)
    first = torch.randint(0, vocab, (batch, 1), **kw)
    flips = torch.rand((batch, seq - 1), **kw) < q
    rand = torch.randint(0, vocab, (batch, seq - 1), **kw)
    return markov_chain(first, flips, rand, vocab)


def make_batch(generator: torch.Generator, cfg: ModelConfig, batch: int,
               seq: int) -> Dict[str, torch.Tensor]:
    """``{"tokens", "labels"}`` (batch, seq): the chain and its shift. The
    audio family's tokens are the chain tiled over its codebooks (batch,
    seq, n_codebooks); the vlm's batch adds ``patch_embeds`` (batch,
    n_patches, VISION_DIM), 0.1 x standard normals in f32 drawn from the
    same generator after the chain (the stub vision tower's output)."""
    from repro_torch.models.model import VISION_DIM
    toks = markov_tokens(generator, batch, seq + 1, cfg.vocab)
    inputs, labels = toks[:, :-1], toks[:, 1:]
    if cfg.family == "audio":
        inputs = inputs[..., None].repeat(1, 1, cfg.n_codebooks)
    out = {"tokens": inputs, "labels": labels}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.randn(
            (batch, cfg.n_patches, VISION_DIM), generator=generator,
            dtype=torch.float32, device=generator.device).mul_(0.1)
    return out


def synthetic_lm_batches(generator: torch.Generator, cfg: ModelConfig,
                         steps: int, batch: int, seq: int
                         ) -> Iterator[Dict[str, torch.Tensor]]:
    """``steps`` batches, drawn one after another from ``generator``."""
    for _ in range(steps):
        yield make_batch(generator, cfg, batch, seq)
