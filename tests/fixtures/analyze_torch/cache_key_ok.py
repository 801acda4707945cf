"""Clean cache keys: ints, strings, constant floats and the card's index
as the arguments of lru-cached functions."""
import functools

import torch


@functools.lru_cache(maxsize=None)
def plan(n, frac):
    return n * frac


@functools.lru_cache(maxsize=None)
def card(index: int):
    return torch.cuda.get_device_properties(index).multi_processor_count


def callers(x: torch.Tensor, n: int):
    return (plan(n, 2), plan(x.shape[0], n // 2), plan(n, 0.5),
            card(torch.cuda.current_device()))
