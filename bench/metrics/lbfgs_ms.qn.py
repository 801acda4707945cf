"""Device ms a QN step in the L-BFGS two-loop and its gamma: the self time
of the ``repro.lbfgs`` spans."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.lbfgs")
