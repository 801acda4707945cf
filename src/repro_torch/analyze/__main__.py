"""Entry point for ``python -m repro_torch.analyze``."""
import sys

from repro_torch.analyze.cli import main

sys.exit(main())
