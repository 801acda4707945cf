"""Host us a serve round inside ``submit_many`` and outside its flush:
the trace's ``repro.serve.submit`` events less the ``repro.serve.flush``
events inside them (the ingest loop and its block writes)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.host_us(run, "repro.serve.submit", "repro.serve.flush")
