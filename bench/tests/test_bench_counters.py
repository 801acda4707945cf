"""The program-counter reader ``b1_replay_share.train`` on a stubbed
``repro_torch.agg.kernel.small_m_counts``: the replayed share of the
small-m path's coordinates in percent, and None on a program without the
counter or where the path computed nothing."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from bench.lib.harness import Run, load_module  # noqa: E402

NAME = "b1_replay_share.train"


def _read():
    return load_module(ROOT / "bench" / "metrics" / f"{NAME}.py", NAME).read(
        Run(ctx=None, cell=None, setup_s=0.0, window_s=1.0, steps=[{}],
            peak_window_bytes=0))


def test_reads_the_replayed_share_of_the_counted_coordinates(monkeypatch):
    from repro_torch.agg import kernel
    monkeypatch.setattr(kernel, "small_m_counts", lambda: {
        "launches": 60, "coords": 8_000, "replayed": 20})
    assert _read() == 0.25


def test_reads_none_where_the_path_computed_nothing(monkeypatch):
    from repro_torch.agg import kernel
    monkeypatch.setattr(kernel, "small_m_counts", lambda: {
        "launches": 0, "coords": 0, "replayed": 0})
    assert _read() is None


def test_reads_none_on_a_program_without_the_counter(monkeypatch):
    from repro_torch.agg import kernel
    monkeypatch.delattr(kernel, "small_m_counts")
    assert _read() is None
