"""``torch.cuda.max_memory_allocated()`` from a reset after set-up to the
end of the window, in GB (1e9 bytes)."""


def read(run):
    if not run.ctx.device.startswith("cuda"):
        return None
    return run.peak_window_bytes / 1e9
