#!/usr/bin/env python3
"""``tools/calibrate.py`` for the Zamba2 cell, whose readings add the
faults ``noembed`` and ``noadapter`` and the reading ``bf16scan`` (the
reference's scan in bf16) to the control and the faults there:

    python3 bench/tools/calibrate_zamba2.py --workload zamba2-qn-step \\
        --seeds 1,2,3 [--control --faults control,half,alter,nonoise,\\
        sigma2,noembed,noadapter,bf16scan] [--out FILE]

Runs where the benchmark runs: on the card."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import calibrate  # noqa: E402

calibrate.FAULTS = calibrate.FAULTS + ("noembed", "noadapter", "bf16scan")

if __name__ == "__main__":
    calibrate.main()
