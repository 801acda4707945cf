"""Device ms a training step in Zamba2's shared-block insertions: the
self time of the ``repro.shared`` spans, each an insertion's shared
block, its adapter and its ``linear`` in the forward pass, its recompute
and its backward pass."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.shared")
