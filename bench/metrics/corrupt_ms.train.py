"""Device ms a training step in the wire's attack: the self time of the
``repro.wire.corrupt`` spans (the Byzantine rows rewritten)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.wire.corrupt")
