"""Differential privacy: Gaussian mechanism with tail-bound sensitivity
(``repro/core/dp.py`` counterpart).

Host-side float calibration of the paper's DP layer (§2.2, §4.2): the
noise multiplier, the per-round noise s.d. s_1..s_6 of Theorems 4.5/4.6,
the Lemma 4.3/4.4 sensitivity failure probabilities, and the
``PrivacyAccountant`` that records the transmissions. Everything here is
Python floats and ``math``, so the port's sigmas equal the reference's
exactly. The per-leaf (pytree) calibration, the advanced-composition
inversion and the Renyi accounting belong to later slices.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import List, Tuple


# ---------------------------------------------------------------- mechanism

def gaussian_sigma(sensitivity: float, eps: float, delta: float) -> float:
    """Lemma 2.1: noise s.d. for (eps, delta)-DP given l2-sensitivity."""
    if eps <= 0 or not (0 < delta < 1):
        raise ValueError("need eps > 0 and 0 < delta < 1")
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / eps


def noise_multiplier(eps: float, delta: float) -> float:
    """The paper's Delta := sqrt(2 log(1/delta)) / eps (Thms 4.4/4.5)."""
    return math.sqrt(2.0 * math.log(1.0 / delta)) / eps


# ------------------------------------------------- tail-bound sensitivities

def mean_dp_failure_prob_subgauss(p: int, n: int, gamma: float,
                                  nu: float) -> float:
    """Lemma 4.3: DP fails with prob <= 2 p n^{-gamma^2/nu^2}."""
    return min(1.0, 2.0 * p * n ** (-(gamma ** 2) / nu ** 2))


def mean_dp_failure_prob_subexp(p: int, n: int, gamma: float, nu: float,
                                alpha: float) -> float:
    """Lemma 4.4: 2 p max{n^{-gamma^2 log n/nu^2}, n^{-gamma/alpha}}."""
    a = n ** (-(gamma ** 2) * math.log(n) / nu ** 2)
    b = n ** (-gamma / alpha)
    return min(1.0, 2.0 * p * max(a, b))


# ----------------------------------------------- protocol noise calibration

def _tail_factor(n: int, tail: str) -> float:
    """sub-exponential: log n; sub-Gaussian: sqrt(log n) (Remark 4.4)."""
    if tail == "subexp":
        return math.log(n)
    if tail == "subgauss":
        return math.sqrt(math.log(n))
    raise ValueError(f"tail must be subexp|subgauss, got {tail!r}")


def s1_theta(p: int, n: int, gamma: float, eps: float, delta: float,
             lambda_s: float, tail: str = "subexp") -> float:
    """Thm 4.5(1): s1 = 2.02 gamma sqrt(p) log(n) Delta / (lambda_s n)."""
    d = noise_multiplier(eps, delta)
    return 2.02 * gamma * math.sqrt(p) * _tail_factor(n, tail) * d / (lambda_s * n)


def s2_grad(p: int, n: int, gamma: float, eps: float, delta: float,
            tail: str = "subexp") -> float:
    """Thm 4.5(2): s2 = 2 gamma sqrt(p) log(n) Delta / n."""
    d = noise_multiplier(eps, delta)
    return 2.0 * gamma * math.sqrt(p) * _tail_factor(n, tail) * d / n


def s3_newton_dir(p: int, n: int, gamma: float, eps: float, delta: float,
                  lambda_s: float, dir_norm: float,
                  tail: str = "subexp") -> float:
    """Thm 4.5(3): s3j = 2.02 gamma sqrt(p) log(n) ||H_j^{-1} g_cq|| Delta / (lambda_s n)."""
    d = noise_multiplier(eps, delta)
    return (2.02 * gamma * math.sqrt(p) * _tail_factor(n, tail)
            * dir_norm * d / (lambda_s * n))


def s4_grad_diff(p: int, n: int, gamma: float, eps: float, delta: float,
                 step_norm: float, tail: str = "subexp") -> float:
    """Thm 4.5(4): s4 = 2 gamma sqrt(p) log(n) ||theta_os - theta_cq|| Delta / n."""
    d = noise_multiplier(eps, delta)
    return 2.0 * gamma * math.sqrt(p) * _tail_factor(n, tail) * step_norm * d / n


def s5_bfgs_dir(p: int, n: int, gamma: float, eps: float, delta: float,
                vh_norm: float, dir_norm: float,
                tail: str = "subexp") -> float:
    """Thm 4.5(5): s5j = 2.02 gamma sqrt(p) log(n) ||V H_j^{-1}|| ||H_j^{-1} V g_os|| Delta / n."""
    d = noise_multiplier(eps, delta)
    return (2.02 * gamma * math.sqrt(p) * _tail_factor(n, tail)
            * vh_norm * dir_norm * d / n)


def s6_variance(p: int, n: int, gamma: float, eps: float,
                delta: float) -> float:
    """§4.3: s6 = sqrt(2) gamma p (4 log n + 1) sqrt(log(1.25 p/delta)) / (n eps)."""
    c = math.sqrt(2.0) * gamma * p * (4.0 * math.log(n) + 1.0) / n
    return c * math.sqrt(math.log(1.25 * p / delta)) / eps


# ---------------------------------------------------------------- composition

def compose_basic(budgets: List[Tuple[float, float]]) -> Tuple[float, float]:
    """Dwork et al. 2006: k queries compose to (sum eps_i, sum delta_i)."""
    return sum(e for e, _ in budgets), sum(d for _, d in budgets)


def compose_advanced(eps: float, delta: float, k: int,
                     slack: float) -> Tuple[float, float]:
    """Cor 4.1 (Kairouz–Oh–Viswanath Thm 3.2): k-fold adaptive composition
    of (eps, delta)-DP mechanisms is (eps_tilde, 1-(1-delta)^k (1-slack))-DP.
    """
    a = k * eps
    common = (math.e ** eps - 1.0) * k * eps / (math.e ** eps + 1.0)
    b = common + eps * math.sqrt(
        2.0 * k * math.log(math.e + math.sqrt(k * eps ** 2) / slack))
    c = common + eps * math.sqrt(2.0 * k * math.log(1.0 / slack))
    eps_tilde = min(a, b, c)
    delta_total = 1.0 - (1.0 - delta) ** k * (1.0 - slack)
    return eps_tilde, delta_total


# ---------------------------------------------------------------- accountant

@dataclasses.dataclass
class QueryRecord:
    name: str
    eps: float
    delta: float
    sigma: float
    failure_prob: float = 0.0


class PrivacyAccountant:
    """Tracks the per-round budgets of Algorithm 1 and reports totals.

    Basic composition (Remark 4.5) plus the tighter Cor 4.1 bound when all
    rounds share (eps, delta).
    """

    def __init__(self) -> None:
        self.records: List[QueryRecord] = []
        #: audit annotations (the advanced-composition fallback), surfaced
        #: by ``summary()``.
        self.notes: List[str] = []
        self._warned_advanced_fallback = False

    def spend(self, name: str, eps: float, delta: float, sigma: float,
              failure_prob: float = 0.0) -> None:
        self.records.append(QueryRecord(name, eps, delta, sigma, failure_prob))

    def total_basic(self) -> Tuple[float, float]:
        return compose_basic([(r.eps, r.delta) for r in self.records])

    def total_advanced(self, slack: float = 1e-3) -> Tuple[float, float]:
        """Cor 4.1 total when all rounds share one (eps, delta); otherwise
        the basic total, with a ledger note and a warning once per
        accountant."""
        if not self.records:
            return 0.0, 0.0
        eps0 = self.records[0].eps
        delta0 = self.records[0].delta
        if any(abs(r.eps - eps0) > 1e-12 or abs(r.delta - delta0) > 1e-12
               for r in self.records):
            note = ("advanced composition fell back to basic: "
                    f"heterogeneous per-round budgets over "
                    f"{len(self.records)} records "
                    f"(eps range [{min(r.eps for r in self.records):.4g}, "
                    f"{max(r.eps for r in self.records):.4g}])")
            if note not in self.notes:
                self.notes.append(note)
            if not self._warned_advanced_fallback:
                warnings.warn(
                    "PrivacyAccountant.total_advanced: per-round budgets "
                    "are heterogeneous, which Cor 4.1 does not cover — "
                    "reporting the basic-composition total instead (noted "
                    "in accountant.notes)", RuntimeWarning, stacklevel=2)
                self._warned_advanced_fallback = True
            return self.total_basic()
        return compose_advanced(eps0, delta0, len(self.records), slack)

    def total_failure_prob(self) -> float:
        """Union bound over the high-probability sensitivity events."""
        return min(1.0, sum(r.failure_prob for r in self.records))

    def summary(self) -> str:
        e_b, d_b = self.total_basic()
        e_a, d_a = self.total_advanced()
        lines = [f"{r.name}: (eps={r.eps:.4g}, delta={r.delta:.4g}) "
                 f"sigma={r.sigma:.4g}" for r in self.records]
        lines.append(f"basic composition:    ({e_b:.4g}, {d_b:.4g})")
        lines.append(f"advanced composition: ({e_a:.4g}, {d_a:.4g})")
        lines.append(f"sensitivity failure prob <= {self.total_failure_prob():.3g}")
        lines.extend(f"note: {n}" for n in self.notes)
        return "\n".join(lines)
