"""B1's share of its roofline (%) in the serve cells: see ``_b1.py``."""
from bench.lib.harness import load_module
from pathlib import Path

_B1 = load_module(Path(__file__).with_name("_b1.py"), "_b1")


def read(run):
    return _B1.share(run)
