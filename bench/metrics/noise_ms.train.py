"""Device ms a training step in the wire's Gaussian mechanism: the self
time of the ``repro.wire.noise`` spans (the normal draws and the add)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.wire.noise")
