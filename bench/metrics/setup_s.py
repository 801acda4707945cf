"""Set-up: from the process's start to the window's start (loading, the
kernels' build where it is not cached, weights and inputs, warm-up and the
first steps)."""


def read(run):
    return run.setup_s
