"""Shared CLI flags for the launchers — ``repro/launch/cli.py``
counterpart, plus ``--device``.

One definition of the flags every launcher shares, so the launchers never
drift apart on them.
"""
from __future__ import annotations

import argparse

from repro_torch import privacy


def add_common_flags(ap: argparse.ArgumentParser,
                     arch_default: str = "xlstm-125m"
                     ) -> argparse.ArgumentParser:
    """Model selection, root seed, placement and accountant flags."""
    ap.add_argument("--config", "--arch", dest="arch", default=arch_default,
                    help="model-zoo config name: one of the reference's ten "
                    "(repro_torch.configs.ARCHS)")
    ap.add_argument("--seed", type=int, default=0,
                    help="root seed; per-purpose generators are seeded "
                    "from independent streams (repro_torch.core.keys)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the machine axis over all visible devices "
                    "(not ported yet: refused)")
    ap.add_argument("--accountant", default="basic",
                    choices=privacy.registered(),
                    help="repro_torch.privacy accountant (default: basic, "
                    "the paper's even split)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap
