"""The yardstick's peaks and the work of the kernels it prices.

Peaks of one NVIDIA H100 SXM5 from NVIDIA's data sheet (dense, no
sparsity, at its 700 W limit): 989e12 FLOP/s in bf16, 67e12 FLOP/s in f32
outside the tensor cores, 3.35e12 bytes/s of HBM. A card set below 700 W
(``nvidia-smi``'s ``power.limit``, which every result line carries) runs
slower under load; the shares stay against the data sheet.

Kernel B1 (``ostat_kernel``) reduces a ``(B, m, p)`` stack of machine
statistics to ``(B, p)``. Its least time is priced from the logical work
of the rule, not from what the kernel reads: the ``B m p`` values read
once in the dtype the wire hands to the aggregation, the ``B p`` result
written once in that dtype, and, for the operations, per coordinate the
median and MAD (a selection over m values each, ``m ceil(log2 m)``
comparisons) and the K composite-quantile indicators (``2 K m``: a
compare and an add each). The larger of bytes over bandwidth and
operations over the f32 peak is the bound.
"""
from __future__ import annotations

import math

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
DCQ_LEVELS = 10


def b1_bytes(B: int, m: int, p: int, value_bytes: int) -> int:
    return (B * m * p + B * p) * value_bytes


def b1_ops(B: int, m: int, p: int, K: int = DCQ_LEVELS) -> int:
    select = m * max(1, math.ceil(math.log2(max(m, 2))))
    return B * p * (2 * select + 2 * K * m)


def b1_least_s(B: int, m: int, p: int, value_bytes: int,
               K: int = DCQ_LEVELS) -> float:
    """The least time of one dcq_mad aggregation of ``(B, m, p)``."""
    return max(b1_bytes(B, m, p, value_bytes) / HBM_BYTES_PER_S,
               b1_ops(B, m, p, K) / PEAK_F32_FLOPS)


def b1_bound_kind(B: int, m: int, p: int, value_bytes: int,
                  K: int = DCQ_LEVELS) -> str:
    """``"bytes"`` or ``"operations"``: which term bounds the launch."""
    return ("bytes" if b1_bytes(B, m, p, value_bytes) / HBM_BYTES_PER_S
            >= b1_ops(B, m, p, K) / PEAK_F32_FLOPS else "operations")


def train_flops(n_params: int, tokens: int) -> float:
    """Model FLOPs of one training step: 6 N D."""
    return 6.0 * n_params * tokens


def mfu(n_params: int, tokens_per_step: int, seconds_per_step: float
        ) -> float:
    """The step's share of the bf16 peak, as a fraction."""
    return train_flops(n_params, tokens_per_step) / (
        seconds_per_step * PEAK_BF16_FLOPS)
