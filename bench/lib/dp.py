"""The Gaussian mechanism's calibration as the paper states it (Thm 4.5
(2), Lemma 4.4): for a transmitted vector of dimension d from a machine
of n samples at budget (eps, delta) and tail constant gamma,

    sigma = 2 gamma sqrt(d) log(n) Delta / n,
    Delta = sqrt(2 log(1/delta)) / eps.

The workload files hold each leaf's sigma worked out by this formula;
``tools/sigmas.py`` writes them."""
from __future__ import annotations

import math


def sigma(d: int, n: int, gamma: float, eps: float, delta: float) -> float:
    return (2.0 * gamma * math.sqrt(d) * math.log(n)
            * math.sqrt(2.0 * math.log(1.0 / delta)) / eps / n)
