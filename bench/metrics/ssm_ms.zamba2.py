"""Device ms a training step in Zamba2's Mamba2 layers: the self time of
the ``repro.ssm`` spans, each a layer's RMS norm, mixer and residual in
the forward pass, its recompute and its backward pass (the gradient's
scatter into the stacked leaves outside them, in ``repro.model``)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.ssm")
