"""Suppression round-trip fixture: one violation with a reasoned
suppression (must be silenced and reported as suppressed), one with a
bare marker (must stay active as a 'suppression' finding), one naming an
unknown rule."""
import torch


def allowed(shape):
    # repro-torch: allow(generator-seeding) — fixture: kept on the global
    # stream for parity.
    return torch.randn(shape)


def bare_marker(shape):
    # repro-torch: allow(generator-seeding)
    return torch.randn(shape)


def unknown_rule(shape, gen):
    # repro-torch: allow(made-up-rule) — no such rule registered.
    return torch.randn(shape, generator=gen)
