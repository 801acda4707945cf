"""The device trace of a measured window, kept in memory.

``torch.profiler`` records the host's operations and the card's kernels,
copies and fills; the raw events are read (not the profiler's event tree,
which takes ~0.2 ms an event to build, far too slow for a window of a
million events) and nothing is exported. The window is the span of the
harness's ``bench.window`` record: busy time is the union of the device
events inside it, and each idle gap inside it is named by the innermost
host operation running at its middle.
"""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_SPAN = "bench.window"


@dataclass
class Trace:
    """Device events ``(name, start_us, end_us)`` and host events of one
    traced window, and the window's own bounds in the trace's clock."""
    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    _merged: List[Tuple[float, float]] = field(default=None, repr=False)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def merged(self) -> List[Tuple[float, float]]:
        """The union of the device events, clipped to the window, as
        disjoint intervals in order."""
        if self._merged is None:
            lo_w, hi_w = self.window
            spans = sorted((max(s, lo_w), min(e, hi_w))
                           for _, s, e in self.device if e > lo_w and s < hi_w)
            out: List[Tuple[float, float]] = []
            for s, e in spans:
                if out and s <= out[-1][1]:
                    if e > out[-1][1]:
                        out[-1] = (out[-1][0], e)
                else:
                    out.append((s, e))
            self._merged = out
        return self._merged

    def busy_us(self) -> float:
        return sum(e - s for s, e in self.merged())

    def kernel_us(self, substring: str) -> float:
        """Device time of the events whose name contains ``substring``,
        inside the window."""
        lo_w, hi_w = self.window
        return sum(min(e, hi_w) - max(s, lo_w) for n, s, e in self.device
                   if substring in n and e > lo_w and s < hi_w)

    def device_ops(self, top: int = 10) -> List[List]:
        """The ``top`` device operations by summed time, in seconds."""
        lo_w, hi_w = self.window
        by: Dict[str, float] = {}
        for n, s, e in self.device:
            if e > lo_w and s < hi_w:
                by[n] = by.get(n, 0.0) + min(e, hi_w) - max(s, lo_w)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t / 1e6] for n, t in ranked]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle time inside the window summed by what the host was doing
        (the innermost host operation running at each gap's middle), the
        ``top`` largest, in seconds."""
        lo_w, hi_w = self.window
        bounds = [lo_w] + [x for iv in self.merged() for x in iv] + [hi_w]
        gaps = [(bounds[i], bounds[i + 1])
                for i in range(0, len(bounds) - 1, 2)
                if bounds[i + 1] > bounds[i]]
        host = sorted((s, e, n) for n, s, e in self.host
                      if n != WINDOW_SPAN)
        starts = [h[0] for h in host]
        by: Dict[str, float] = {}
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:20000]:
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid)
            best, best_len = "host", None
            for j in range(i - 1, max(-1, i - 4000), -1):
                hs, he, hn = host[j]
                if he >= mid and (best_len is None or he - hs < best_len):
                    best, best_len = hn, he - hs
            by[best] = by.get(best, 0.0) + (e - s)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, t / 1e6] for n, t in ranked]


@contextlib.contextmanager
def window_span():
    """The ``bench.window`` record around the measured window."""
    from torch.profiler import record_function
    with record_function(WINDOW_SPAN):
        yield


class Recorder:
    """``with Recorder() as rec: ...`` traces the block on the host and
    the card; ``rec.trace`` is the :class:`Trace` afterwards (None when no
    ``bench.window`` span was recorded)."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.trace = None
        return self

    def __exit__(self, *exc):
        import torch
        from torch.autograd import DeviceType
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        dev, host, window = [], [], None
        for e in self._prof.profiler.kineto_results.events():
            item = (e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            if e.device_type() == DeviceType.CUDA:
                if item[0] != WINDOW_SPAN:      # the span's device track
                    dev.append(item)
            else:
                host.append(item)
                if item[0] == WINDOW_SPAN:
                    window = (item[1], item[2])
        if window is not None:
            self.trace = Trace(dev, host, window)
        return False
