"""Seeded generator-seeding violations: draws from the process-wide
stream, an arithmetic seed, and one seed for two generators. The analyzer
must flag every site."""
import torch


def global_stream(shape):
    return torch.randn(shape)                     # VIOLATION: no generator=


def in_place_global(x):
    return x.normal_()                            # VIOLATION: no generator=


def arithmetic_seed(seed, rank):
    g = torch.Generator()
    g.manual_seed(seed + rank)                    # VIOLATION: arithmetic
    return g


def one_seed_two_generators(seed):
    a = torch.Generator().manual_seed(seed)
    b = torch.Generator().manual_seed(seed)       # VIOLATION: same seed
    return a, b


def one_seed_in_a_loop(seed, names):
    # VIOLATION: every name's generator gets the same seed
    return {n: torch.Generator().manual_seed(seed) for n in names}
