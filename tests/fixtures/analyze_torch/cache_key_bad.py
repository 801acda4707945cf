"""Seeded cache-key violations: a float value, a float-valued expression,
an unhashable literal and a tensor passed to an lru-cached function —
each distinct value (or object) is a new cache entry, or a TypeError."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def plan(n, frac):
    return n * frac


def callers(n, frac):
    a = plan(n, float(frac))          # VIOLATION: float(...)
    b = plan(n, n / 3)                # VIOLATION: float-valued expression
    c = plan(n, [1, 2])               # VIOLATION: unhashable list
    d = plan(torch.tensor(n), 1)      # VIOLATION: tensor
    return a, b, c, d
