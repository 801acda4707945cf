"""Device ms a training step in B1's f32 round trip: the self time of the
``repro.b1.widen`` spans (each stacked leaf copied to f32 and the result
cast back; the launch inside is ``repro.b1``)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.b1.widen")
