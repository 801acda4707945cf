"""``repro_torch`` — the PyTorch/CUDA port of ``repro``.

Laid out module for module like ``src/repro/``, so each counterpart is
easy to find. It imports ``torch`` and never ``jax``, and nothing of the
JAX package. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; a call that asks for the card on a machine without one
raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise. Raises ``RuntimeError`` when that is a CUDA device and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
