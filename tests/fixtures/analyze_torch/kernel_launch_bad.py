"""Seeded kernel-launch violations: a launch without the caller's stream,
the data pointer of a tensor never checked contiguous, and the plain
twin as the fallback of a failed build or launch."""
from pathlib import Path

import torch

from repro_torch.cuda_build import CudaLibrary

LIBRARY = CudaLibrary("twice", Path("csrc/twice.cu"), Path("_build"),
                      lambda lib: None)


def build():
    return LIBRARY.build()


def twice_plain(x):
    return 2 * x


def twice(x):
    out = torch.empty_like(x)
    try:
        lib = build()
        # VIOLATION: no stream; VIOLATION: x never checked contiguous
        lib.twice_launch(x.data_ptr(), out.data_ptr(), x.numel())
    except RuntimeError:
        return twice_plain(x)          # VIOLATION: hides the kernel
    return out
