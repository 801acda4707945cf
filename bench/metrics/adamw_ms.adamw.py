"""Device ms an AdamW step in the optimizer: the self time of the
``repro.optim`` spans (``AdamW.update`` and ``apply_updates``)."""
from bench.lib.harness import load_module
from pathlib import Path

_S = load_module(Path(__file__).with_name("_spans.py"), "_spans")


def read(run):
    return _S.self_ms(run, "repro.optim")
