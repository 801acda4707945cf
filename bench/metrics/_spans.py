"""What the span readers share. ``self_ms``: a span's self device time
(its interval less its direct children's, ``repro_torch.obs.spans()``)
a step of the traced window. ``host_us``: the host time a step that the
trace's host events of one span name cover and those of another do not.
Each is None where the program has no such span: a program without
``repro_torch.obs``, or a span that did not run or was not timed.

``self_ms`` reads the process's totals, every span closed under any
profiler since the process started (nothing resets them at the window's
start), and divides by this window's steps: it holds one traced window
a process, as ``bench/run.py`` runs it, with no profiler during set-up.
A caller that traces two windows in one process reads the first's spans
in the second unless it calls ``repro_torch.obs.reset()`` before the
window opens."""


def self_ms(run, name):
    if run.trace is None or not run.steps:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    count, ms = obs.spans().get(name, (0, None))
    if not count or ms is None:
        return None
    return ms / len(run.steps)


def _union(events, name, lo, hi):
    """The union of ``name``'s events clipped to [lo, hi], as disjoint
    intervals in order."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for n, s, e in events
                       if n == name and e > lo and s < hi):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(e, out[-1][1]))
        else:
            out.append((s, e))
    return out


def _overlap(a, b):
    """The length of the intersection of two lists of disjoint intervals
    in order."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_us(run, inside, outside=None):
    if run.trace is None or not run.steps:
        return None
    lo, hi = run.trace.window
    a = _union(run.trace.host, inside, lo, hi)
    if not a:
        return None
    b = _union(run.trace.host, outside, lo, hi) if outside else []
    return (sum(e - s for s, e in a) - _overlap(a, b)) / len(run.steps)
