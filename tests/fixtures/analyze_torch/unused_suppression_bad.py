"""Seeded unused-suppression violations: reasoned waivers whose rule runs
but never fires here. Both must be flagged as stale — the inline allow on
a seeded draw and the file-wide allow-file whose rule finds nothing in
this module."""
# repro-torch: allow-file(wire-boundary) — VIOLATION: no raw dispatch below.
import torch


def seeded(shape, gen):
    # repro-torch: allow(generator-seeding) — VIOLATION: the draw is seeded.
    return torch.randn(shape, generator=gen)
