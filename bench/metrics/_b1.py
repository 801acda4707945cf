"""Kernel B1's share of its roofline over a traced window: the least
time of every aggregation the window's steps made, priced from the
cell's own sizes (``bench.lib.roofline.b1_least_s``), over the device
time of the kernels named ``ostat_kernel``. None where the trace holds no
such kernel."""
from bench.lib.roofline import b1_least_s


def share(run):
    if run.trace is None:
        return None
    dev_us = run.trace.kernel_us("ostat_kernel")
    if dev_us <= 0:
        return None
    steps = len(run.steps)
    least_s = sum(b1_least_s(B, m, p, nbytes) * count * steps
                  for B, m, p, nbytes, count in run.cell.b1_launches())
    return 100.0 * least_s / (dev_us / 1e6)
