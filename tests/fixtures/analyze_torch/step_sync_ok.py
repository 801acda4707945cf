"""Clean step: device-side branching, host casts of shapes and of
scalar-annotated parameters only; host reads outside the step."""
import torch

STEP_ROOTS = ("train_step",)


def train_step(x, lr: float):
    x = torch.where(x.mean() > 0, x - 1.0, x)
    n = x.shape[0]
    half = int(n // 2)
    return x[:half] * float(lr) + x.numel()


def host_report(x):
    # not step-reachable: reading the value on the host is fine here
    return float(x.mean())
