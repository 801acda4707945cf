"""Host us a serve round that the flush waits for the card: the trace's
``repro.serve.sync`` events."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.host_us(run, "repro.serve.sync")
