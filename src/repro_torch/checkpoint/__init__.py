"""Checkpointing (flat-path npz, atomic) — ``repro.checkpoint``
counterpart."""
from repro_torch.checkpoint.checkpoint import restore, save

__all__ = ["save", "restore"]
