"""Clean twin: every waiver earns its keep. One suppression silences a
real generator-seeding finding; the other names unused-suppression
alongside its rule, the documented self-waiver for a deliberately
prophylactic marker."""
import torch


def earned(shape):
    # repro-torch: allow(generator-seeding) — fixture: global stream kept.
    return torch.randn(shape)


def prophylactic(shape, gen):
    # repro-torch: allow(generator-seeding, unused-suppression) — fixture:
    # kept for a caller that may pass no generator on some platforms.
    return torch.randn(shape, generator=gen)
