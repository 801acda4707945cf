"""Clean generator hygiene: every sampler takes a seeded generator (or the
caller's, through **kw), seeds are derived per stream, and a seed reused
only on exclusive branches. The analyzer must stay silent."""
import torch

from repro_torch.core.keys import stream_seed


def seeded_draw(gen, shape):
    return torch.randn(shape, generator=gen)


def forwarded(shape, **kw):
    return torch.rand(shape, **kw)


def in_place(x, gen):
    return x.normal_(generator=gen)


def derived_streams(seed, names):
    return {n: torch.Generator().manual_seed(stream_seed(seed, "protocol", i))
            for i, n in enumerate(names)}


def one_generator_per_seed(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def either_device(seed, on_card):
    if on_card:
        g = torch.Generator(device="cuda").manual_seed(seed)
    else:
        g = torch.Generator().manual_seed(seed)
    return g


def reseeded(seed, other):
    a = torch.Generator().manual_seed(seed)
    seed = other
    b = torch.Generator().manual_seed(seed)
    return a, b
