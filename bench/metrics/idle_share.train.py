"""The device's idle share (%) of the traced window in the train cells:
1 - (the union of device events inside the window) / (the window)."""


def read(run):
    if run.trace is None or run.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / run.trace.window_us)
