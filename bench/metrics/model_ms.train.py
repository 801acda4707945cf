"""Device ms a training step in the model's passes: the self time of the
``repro.model`` spans (each machine's forward and ``autograd.grad``)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.model")
