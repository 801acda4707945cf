"""Differential privacy: Gaussian mechanism with tail-bound sensitivity
(``repro/core/dp.py`` counterpart).

Host-side float calibration of the paper's DP layer (§2.2, §4.2): the
noise multiplier, the per-round noise s.d. s_1..s_6 of Theorems 4.5/4.6,
the Lemma 4.3/4.4 sensitivity failure probabilities, and the
``PrivacyAccountant`` that records the transmissions. Everything here but
the mechanism itself (``add_noise``) is Python floats and ``math``, so
the port's sigmas equal the reference's exactly; so do the composition bounds the accountants of
``repro_torch.privacy`` invert (Cor 4.1 and the Renyi curves), and the
per-leaf sigmas of one transmitted pytree (``tree_mean_sigma``, which the
serving wire uses) and the per-transmission tree calibration of the
model-scale engine (``calibrate_tree_sigmas``, ``tree_spend_ledger``).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any, List, Optional, Tuple

import torch


# ---------------------------------------------------------------- mechanism

def gaussian_sigma(sensitivity: float, eps: float, delta: float) -> float:
    """Lemma 2.1: noise s.d. for (eps, delta)-DP given l2-sensitivity."""
    if eps <= 0 or not (0 < delta < 1):
        raise ValueError("need eps > 0 and 0 < delta < 1")
    return math.sqrt(2.0 * math.log(1.25 / delta)) * sensitivity / eps


def noise_multiplier(eps: float, delta: float) -> float:
    """The paper's Delta := sqrt(2 log(1/delta)) / eps (Thms 4.4/4.5)."""
    return math.sqrt(2.0 * math.log(1.0 / delta)) / eps


def add_noise(key, x, s: float):
    """Gaussian mechanism G(X, s) = M(X) + N(0, s^2 I). Where the reference
    takes a PRNG key, ``key`` is a ``torch.Generator`` on ``x``'s device
    (one draw shaped like ``x``) or the standard normals themselves."""
    z = key if isinstance(key, torch.Tensor) else torch.randn(
        x.shape, generator=key, dtype=x.dtype, device=x.device)
    return x + s * z.to(dtype=x.dtype, device=x.device)


# ------------------------------------------------- tail-bound sensitivities

def mean_sensitivity_subgauss(p: int, n: int, gamma: float) -> float:
    """Lemma 4.3: Delta = 2*gamma*sqrt(p log n)/n for sub-Gaussian means."""
    return 2.0 * gamma * math.sqrt(p * math.log(n)) / n


def mean_sensitivity_subexp(p: int, n: int, gamma: float) -> float:
    """Lemma 4.4: Delta = 2*gamma*sqrt(p)*log(n)/n for sub-exponential means."""
    return 2.0 * gamma * math.sqrt(p) * math.log(n) / n


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


def variance_sensitivity(n: int, gamma: float) -> float:
    """Thm 4.6: Delta = (4*gamma*log n + 1)/n for a sub-Gaussian sample
    variance (untrusted-center variance transmission)."""
    if gamma < 1:
        raise ValueError("Thm 4.6 requires gamma >= 1")
    return (4.0 * gamma * math.log(n) + 1.0) / n


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


#: slack grid for inverting Cor 4.1: fractions of the total delta handed
#: to the composition slack (the rest is split over the k rounds).
_ADVANCED_SLACK_FRACS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 0.9)


def invert_advanced(eps: float, delta: float, k: int,
                    slack_fracs=_ADVANCED_SLACK_FRACS
                    ) -> Tuple[float, float]:
    """Largest per-round (eps_r, delta_r) whose k-fold Cor 4.1 composition
    stays within total (eps, delta) — the CALIBRATION direction of
    advanced composition, best-of with the basic eps/k split.

    For each slack fraction the per-round delta_r solves
    1-(1-delta_r)^k (1-slack) = delta exactly, and eps_r is bisected on
    the (monotone) sqrt-k bounds b/c of Cor 4.1. The basic candidate
    (eps/k, delta/k) is always in the pool, so the result is never a
    LARGER noise multiplier than basic; at the paper's k in {5, 6} it IS
    basic (Cor 4.1's sqrt-k regime needs k >~ 2 ln(1/slack) ~ 23+), and
    the strict win appears at many-round scale. Returns the candidate
    minimizing :func:`noise_multiplier`.
    """
    if eps <= 0 or not (0 < delta < 1) or k < 1:
        raise ValueError("need eps > 0, 0 < delta < 1, k >= 1")
    best = (eps / k, delta / k)
    for frac in slack_fracs:
        slack = frac * delta
        delta_r = 1.0 - ((1.0 - delta) / (1.0 - slack)) ** (1.0 / k)
        if delta_r <= 0.0:
            continue

        def bound_bc(e: float) -> float:
            common = (math.e ** e - 1.0) * k * e / (math.e ** e + 1.0)
            b = common + e * math.sqrt(
                2.0 * k * math.log(math.e + math.sqrt(k * e * e) / slack))
            c = common + e * math.sqrt(2.0 * k * math.log(1.0 / slack))
            return min(b, c)

        lo, hi = 0.0, eps          # bound_bc(eps) > eps in any DP regime
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            if bound_bc(mid) <= eps:
                lo = mid
            else:
                hi = mid
        if lo > 0.0 and noise_multiplier(lo, delta_r) \
                < noise_multiplier(*best):
            best = (lo, delta_r)
    return best


# --------------------------------------------------------- Renyi accounting

def rdp_gaussian_epsilon(mu: float, alpha: float, k: int = 1) -> float:
    """Renyi-DP curve of k composed Gaussian mechanisms at noise
    multiplier mu (sigma = mu * sensitivity): eps_alpha = k alpha/(2 mu^2)
    (Mironov 2017, Prop 7 + additivity under composition)."""
    return k * alpha / (2.0 * mu * mu)


def rdp_to_dp(eps_alpha: float, alpha: float, delta: float) -> float:
    """Tight RDP -> (eps, delta) conversion (Canonne–Kamath–Steinke '20 /
    Balle et al. '20): eps = eps_alpha + log((alpha-1)/alpha)
    - (log delta + log alpha)/(alpha - 1). Requires alpha > 1."""
    if alpha <= 1.0:
        raise ValueError("RDP order alpha must exceed 1")
    return (eps_alpha + math.log((alpha - 1.0) / alpha)
            - (math.log(delta) + math.log(alpha)) / (alpha - 1.0))


#: default RDP order grid: dense near 1 (tiny budgets), log-spread above.
RDP_ALPHAS = tuple([1.0 + x / 10.0 for x in range(1, 10)]
                   + list(range(2, 64)) + [80, 128, 256, 512, 1024])


def rdp_total_epsilon(mu: float, k: int, delta: float,
                      alphas=RDP_ALPHAS) -> float:
    """(eps, delta) guarantee of k composed Gaussian releases at noise
    multiplier mu: the tight conversion optimized over the order grid."""
    return min(rdp_to_dp(rdp_gaussian_epsilon(mu, a, k), a, delta)
               for a in alphas)


def calibrate_rdp_multiplier(eps: float, delta: float, k: int) -> float:
    """Smallest per-round noise multiplier mu such that k Gaussian
    releases at sigma = mu * sensitivity compose to (eps, delta)-DP under
    RDP with the tight conversion. Bisection (total eps is monotone
    decreasing in mu); host-side Python floats only."""
    if eps <= 0 or not (0 < delta < 1) or k < 1:
        raise ValueError("need eps > 0, 0 < delta < 1, k >= 1")
    lo, hi = 1e-4, 1.0
    while rdp_total_epsilon(hi, k, delta) > eps:
        hi *= 2.0
        if hi > 1e10:
            raise ValueError(f"no Gaussian multiplier reaches eps={eps}")
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if rdp_total_epsilon(mid, k, delta) > eps:
            lo = mid
        else:
            hi = mid
    return hi


# ------------------------------------------- per-leaf (pytree) calibration

def tree_mean_sigma(tree_dims: Any, n: int, gamma: float, eps_r: float,
                    delta_r: float, tail: str = "subexp") -> Any:
    """Per-leaf noise s.d. for ONE transmitted pytree: the Lemma 4.4 mean
    mechanism (``s2_grad``) calibrated at each leaf's own dimension.
    ``tree_dims``: a tree of ints (``transport.tree_leaf_dims``). Returns
    a matching tree of Python-float sigmas."""
    from repro_torch.core.transport import tree_map
    return tree_map(
        # repro-torch: allow(step-sync) — host-only: d is a leaf's Python int
        # dimension
        lambda d: s2_grad(int(d), n, gamma, eps_r, delta_r, tail), tree_dims)


#: the five pytree-engine transmissions, in wire order (Algorithm 1's
#: vector rounds at model scale; no untrusted-variance round).
TREE_TRANSMISSIONS = ("R1 theta", "R2 grad", "R3 newton-dir",
                      "R4 grad-diff", "R5 bfgs-dir")


def calibrate_tree_sigmas(tree: Any, n: int, eps: float, delta: float,
                          gammas=(2.0, 2.0, 2.0, 2.0, 2.0),
                          tail: str = "subexp", machine_axis: bool = False,
                          accountant: str = "basic") -> dict:
    """Per-transmission, per-leaf noise s.d. of the pytree protocol:
    ``{transmission name: tree of Python-float sigmas}``.

    The total (eps, delta) is split over the five transmissions by the
    named ``accountant`` (the ``repro_torch.privacy`` registry). "basic"
    is the even eps/5 split and is never rescaled, not even by 1.0; any
    other accountant scales the basic sigmas by its ``multiplier_ratio``.
    Every transmission uses the sub-exponential mean mechanism (Lemma 4.4)
    at its round's ``gamma`` and each leaf's own dimension."""
    from repro_torch.core.transport import tree_leaf_dims, tree_map
    k = len(TREE_TRANSMISSIONS)
    eps_r, delta_r = eps / k, delta / k
    dims = tree_leaf_dims(tree, machine_axis=machine_axis)
    sigmas = {name: tree_mean_sigma(dims, n, gammas[i], eps_r, delta_r,
                                    tail)
              for i, name in enumerate(TREE_TRANSMISSIONS)}
    if accountant != "basic":
        from repro_torch.privacy import multiplier_ratio
        ratio = multiplier_ratio(accountant, eps, delta, k)
        if ratio != 1.0:
            sigmas = {name: tree_map(lambda s: s * ratio, t)
                      for name, t in sigmas.items()}
    return sigmas


def tree_spend_ledger(tree: Any, n: int, eps: float, delta: float,
                      gammas=(2.0, 2.0, 2.0, 2.0, 2.0),
                      tail: str = "subexp", machine_axis: bool = False,
                      accountant: str = "basic") -> List[dict]:
    """Flat per-(transmission, leaf) spend records: the leaf path, its
    dimension, the sigma that dimension bought, the per-round budget and
    the accountant that certified it; high-probability accountants add
    each leaf's Lemma 4.4 failure probability."""
    from repro_torch.core.transport import (leaf_paths, tree_leaf_dims,
                                            tree_leaves)
    from repro_torch.privacy import get_accountant
    acct = get_accountant(accountant)
    k = len(TREE_TRANSMISSIONS)
    eps_r, delta_r = acct.per_round(eps, delta, k)
    sigmas = calibrate_tree_sigmas(tree, n, eps, delta, gammas, tail,
                                   machine_axis, accountant=accountant)
    paths = leaf_paths(tree)
    dims = tree_leaves(tree_leaf_dims(tree, machine_axis=machine_axis))
    records = []
    for i, name in enumerate(TREE_TRANSMISSIONS):
        for path, d, s in zip(paths, dims, tree_leaves(sigmas[name])):
            rec = {"transmission": name, "leaf": path, "dim": int(d),
                   "sigma": float(s), "eps": eps_r, "delta": delta_r,
                   "accountant": acct.name}
            if acct.failure_prob is not None:
                rec["failure_prob"] = acct.failure_prob(int(d), n,
                                                        gammas[i])
            records.append(rec)
    return records


# ---------------------------------------------------------------- accountant

@dataclasses.dataclass
class QueryRecord:
    name: str
    eps: float
    delta: float
    sigma: float
    failure_prob: float = 0.0
    #: pytree transmissions: one ``{leaf, sigma}`` per leaf
    per_leaf: Optional[List[dict]] = None


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

    def spend_tree(self, name: str, eps: float, delta: float,
                   sigma_tree: Any) -> None:
        """One pytree transmission is ONE composition entry: every leaf is
        released by one mechanism under the same (eps, delta). The per-leaf
        sigmas ride on the record; its scalar sigma is the largest
        leaf's."""
        from repro_torch.core.transport import leaf_paths, tree_leaves
        sig_leaves = [float(s) for s in tree_leaves(sigma_tree)]
        per_leaf = [{"leaf": pth, "sigma": s}
                    for pth, s in zip(leaf_paths(sigma_tree), sig_leaves)]
        self.records.append(QueryRecord(
            name, eps, delta, max(sig_leaves) if sig_leaves else 0.0,
            per_leaf=per_leaf))

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
