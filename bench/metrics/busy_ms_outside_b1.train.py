"""Device-busy milliseconds a training step outside kernel B1 (the
model, the wire, the tree engine and the optimizer together), over the
traced window."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    busy = run.trace.busy_us() - run.trace.kernel_us("ostat_kernel")
    return busy / 1e3 / len(run.steps)
