"""Host us a serve round inside the flush and outside its wait for the
card: the trace's ``repro.serve.flush`` events less the
``repro.serve.sync`` events inside them."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.host_us(run, "repro.serve.flush", "repro.serve.sync")
