"""The protocol's configuration (``repro/configs/base.py`` counterpart).

Only ``ProtocolConfig`` is ported: the flat Algorithm 1 path is the only
user of this package so far. Same fields and defaults as the reference,
so ``dataclasses.asdict`` of one builds the other
(``repro_torch.interop.config_from_reference``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ProtocolConfig:
    """Algorithm 1 configuration (paper §4)."""
    K: int = 10                  # composite-quantile levels (paper uses 10)
    eps: float = 30.0            # total privacy budget (split over 5 rounds)
    delta: float = 0.05
    # Algorithm 1's fixed 5 vector rounds; untrusted-center mode adds a
    # sixth DP transmission ("R2b var"), see core/protocol.py
    # transmission_names.
    n_rounds: int = 5
    gammas: Tuple[float, ...] = (2.0, 2.0, 2.0, 2.0, 2.0)  # gamma_1..gamma_5
    # Lower bound on the Hessian eigenvalue (Assumption 7.3). None => each
    # machine calibrates from the eigenvalues of its LOCAL Hessian.
    lambda_s: float | None = None
    tail: str = "subexp"         # subexp | subgauss (Thm 4.5 vs Lemma 39)
    aggregator: str = "dcq"      # dcq | median | trimmed | mean
    trim_beta: float = 0.2       # trimmed-mean fraction
    center_trust: str = "trusted"  # trusted | untrusted (paper §4.3)
    newton_steps: int = 25       # local solver iterations
    noiseless: bool = False      # ablation: no DP noise
    # Composition accountant. Only "basic" (the eps/5, eps/6 untrusted,
    # split) is ported; the protocol raises NotImplementedError otherwise.
    accountant: str = "basic"
