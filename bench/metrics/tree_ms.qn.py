"""Device ms a QN step in the tree engine's own algebra: the self time of
the ``repro.tree`` span (local steps, row buffers, theta updates, the
curvature test), outside the model, the wire, B1 and the two-loop."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.tree")
