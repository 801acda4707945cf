"""Seeded step-sync violations: host reads, a host cast, numpy, a
syncing torch call and a Python branch on a tensor, inside a declared
step root and a helper it reaches."""
import numpy as np
import torch

STEP_ROOTS = ("train_step",)


def helper(x):
    return x.sum().item()                 # VIOLATION: .item(), reached


def train_step(x, lr):
    if x.mean() > 0:                      # VIOLATION: branch on a tensor
        x = x - 1.0
    scale = float(x.max())                # VIOLATION: host cast
    host = np.asarray(x.cpu())            # VIOLATION: numpy, and .cpu()
    idx = torch.nonzero(x)                # VIOLATION: output size on host
    return x * scale + helper(x) + host.sum() + idx.numel()
