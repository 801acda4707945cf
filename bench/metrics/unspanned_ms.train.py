"""Device ms a training step that no inner span covers: the self time of
the ``repro.step`` spans (row copies, the metrics' norms, the final copy
into the parameters, and the card's idle time between them)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.step")
