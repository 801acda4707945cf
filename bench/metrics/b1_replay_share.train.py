"""The share (%) of the coordinates B1's small-m path computed in this
process whose search it replayed instead of taking in closed form
(``repro_torch.agg.kernel.small_m_counts``; the counters cover the whole
process, set-up included). None where the program has no such counter, or
where the path computed no coordinate."""


def read(run):
    try:
        from repro_torch.agg import kernel
    except ImportError:
        return None
    counts = getattr(kernel, "small_m_counts", None)
    if counts is None:
        return None
    c = counts()
    if not c["coords"]:
        return None
    return 100.0 * c["replayed"] / c["coords"]
