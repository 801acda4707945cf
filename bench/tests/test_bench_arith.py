"""The yardstick's arithmetic on known values: the trace reader, the
window's statistics, the roofline and MFU counts, the seeds."""
import math
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench.lib import roofline, stats  # noqa: E402
from bench.lib.seeds import derive  # noqa: E402
from bench.lib.trace import WINDOW_SPAN, Trace  # noqa: E402


def _trace():
    dev = [("ostat_kernel<5, 4>", 10.0, 30.0), ("gemm", 25.0, 40.0),
           ("ostat_kernel<5, 4>", 60.0, 70.0), ("copy", 90.0, 120.0)]
    host = [(WINDOW_SPAN, 0.0, 100.0), ("aten::linalg_solve", 40.0, 60.0),
            ("aten::item", 45.0, 55.0), ("step", 0.0, 100.0)]
    return Trace(dev, host, (0.0, 100.0))


def test_trace_busy_is_the_union_inside_the_window():
    t = _trace()
    assert t.merged() == [(10.0, 40.0), (60.0, 70.0), (90.0, 100.0)]
    assert t.busy_us() == 50.0
    assert t.window_us == 100.0
    assert t.kernel_us("ostat_kernel") == 30.0


def test_trace_device_ops_and_idle_gaps():
    t = _trace()
    assert t.device_ops(2) == [["ostat_kernel<5, 4>", 30e-6],
                               ["gemm", 15e-6]]
    gaps = dict((n, s) for n, s in t.idle_gaps())
    # [0, 10) and [70, 90) lie under "step" alone; [40, 60) under the
    # solve and, at its middle, the innermost item
    assert gaps == {"step": pytest.approx(30e-6),
                    "aten::item": pytest.approx(20e-6)}


def test_percentile_and_spread():
    assert stats.percentile([1, 2, 3, 4, 5], 50) == 3
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.percentile([10.0], 95) == 10.0
    assert stats.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_norm_gaps_worst_and_moved_leaves():
    prog = {"a": 1.01, "b": 0.0, "c": 2.0}
    ref = {"a": 1.0, "b": 1e-6, "c": 2.0}
    gaps = stats.norm_gaps(prog, ref)
    # each leaf against max(its own norm, the median leaf's = 1.0)
    assert gaps == pytest.approx({"a": 0.01, "b": 1e-6, "c": 0.0})
    assert stats.worst(gaps) == pytest.approx(0.01)
    assert stats.worst({"a": math.nan}) == math.inf
    assert stats.moved_leaves(ref) == ["a", "c"]


def test_b1_least_time_is_bytes_bound_at_both_regimes():
    # (1, 4, 620.8M) bf16: 5 x 620.8M values of 2 bytes
    d = 620_756_992
    assert roofline.b1_bytes(1, 4, d, 2) == 5 * d * 2
    assert roofline.b1_least_s(1, 4, d, 2) == pytest.approx(
        10 * d / 3.35e12)
    assert roofline.b1_bound_kind(1, 4, d, 2) == "bytes"
    # (1, 16384, 10) f32: 16385 x 10 values of 4 bytes
    assert roofline.b1_least_s(1, 16384, 10, 4) == pytest.approx(
        16385 * 10 * 4 / 3.35e12)
    assert roofline.b1_bound_kind(1, 16384, 10, 4) == "bytes"
    assert roofline.b1_ops(1, 4, 1) == 2 * 4 * 2 + 2 * 10 * 4


def test_mfu():
    n, tokens = 1_649_430_528, 16_384
    assert roofline.train_flops(n, tokens) == 6.0 * n * tokens
    assert roofline.mfu(n, tokens, 1.0) == pytest.approx(
        6.0 * n * tokens / 989e12)


def test_derive_is_stable_and_takes_large_seeds():
    a = derive(2 ** 40 + 7, "weights", "embed")
    assert a == derive(2 ** 40 + 7, "weights", "embed")
    assert a != derive(2 ** 40 + 8, "weights", "embed")
    assert 0 <= a < 2 ** 63
