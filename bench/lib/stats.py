"""Window and percentile arithmetic, and the gaps that decide ``correct``."""
from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    order statistics (numpy's default), over every value given."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median, by ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Iterable[str] = None) -> Dict[str, float]:
    """Per leaf, the gap between the program's norm and the reference's
    (not the norm of their difference), over the reference's norm of that
    leaf or of the median leaf, whichever is larger. ``keep`` limits the
    leaves compared."""
    names = list(ref) if keep is None else list(keep)
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def worst(gaps: Dict[str, float]) -> float:
    """The largest gap; a NaN anywhere reads as infinite."""
    vals = list(gaps.values())
    if any(not math.isfinite(v) for v in vals):
        return math.inf
    return max(vals)


def moved_leaves(first_grad: Dict[str, float], share: float = 1e-3
                 ) -> List[str]:
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others move by round-off alone and are left out of
    the comparison of the parameters' change."""
    med = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= share * med]


def limit_checks(numbers: Dict[str, float], limits: Dict[str, float]
                 ) -> List[Dict]:
    """The numbers a workload's ``limits`` name, each beside its limit."""
    return [{"name": k, "value": numbers[k], "limit": limits[k]}
            for k in sorted(limits)]
