"""Seeds of a run: every input the benchmark makes comes from ``--seed``
through :func:`derive`, so the same seed gives the same inputs on both
sides of a comparison and in every process."""
from __future__ import annotations

import hashlib


def derive(seed: int, *purpose) -> int:
    """A 63-bit generator seed for ``purpose`` under ``seed``: the first
    63 bits of the SHA-256 of ``"<seed>/<purpose>/..."``. Any whole
    ``seed`` is taken, however large."""
    tag = "/".join([str(int(seed))] + [str(p) for p in purpose])
    return int.from_bytes(hashlib.sha256(tag.encode()).digest()[:8],
                          "big") >> 1


def generator(seed: int, *purpose, device="cuda"):
    """A ``torch.Generator`` on ``device`` seeded with :func:`derive`."""
    import torch
    return torch.Generator(device=device).manual_seed(derive(seed, *purpose))
