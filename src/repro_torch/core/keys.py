"""Named random streams: collision-free generator seeds for launchers and
services — ``repro/core/keys.py`` counterpart.

The reference derives each purpose-stream from one root key by
``jax.random.fold_in``; torch generators take an integer seed instead, so
the port hashes the triple: ``stream_seed(seed, stream, index)`` is the
first 63 bits of the SHA-256 of ``"<seed>/<stream index>/<index>"``.
Distinct triples give distinct seeds unless SHA-256 collides, for every
seed range (no arithmetic offsets that overlap). The draws themselves are
torch's, not the reference's: parity tests hand the reference's draws to
the port.
"""
from __future__ import annotations

import hashlib
from typing import Optional

import torch

__all__ = ["STREAMS", "stream_seed", "stream_generator"]

#: the reference's purpose-streams, in its order.
STREAMS = ("params", "data", "protocol", "batches", "attack", "serve",
           "eval")


def stream_seed(seed: int, stream: str, index: Optional[int] = None) -> int:
    """An integer seed for ``stream`` under ``seed`` (and ``index``, a
    per-round or per-step counter). Unknown stream names raise."""
    try:
        idx = STREAMS.index(stream)
    except ValueError:
        raise ValueError(
            f"unknown stream {stream!r}; registered: {STREAMS}") from None
    tag = f"{int(seed)}/{idx}/{'' if index is None else int(index)}"
    digest = hashlib.sha256(tag.encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def stream_generator(seed: int, stream: str, index: Optional[int] = None,
                     device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with
    :func:`stream_seed`."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))
