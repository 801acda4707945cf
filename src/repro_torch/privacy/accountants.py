"""The four registered accountants: basic, advanced, rdp, subexp —
``repro/privacy/accountants.py`` counterpart.

All composition/inversion math lives in ``repro_torch.core.dp`` (it is DP
theory, unit-tested there); this module only binds it into registry
entries. Numbers at the paper's §5 operating point — total budget
(eps=5, delta=1e-5) over the six untrusted-center transmissions:

  ============  =================  ==========================
  accountant    per-round sigma    note
  ============  =================  ==========================
  basic         1.00x (reference)  eps/k split, Remark 4.5
  advanced      1.00x at k=6       Cor 4.1's sqrt-k regime needs
                (< 1 for k >~ 25)  k >~ 2 ln(1/delta); best-of
                                   with basic, never worse
  rdp           ~0.38x             Gaussian Renyi curves, tight
                                   conversion — the real win
  subexp        1.00x              basic sigmas + the paper's
                                   high-prob failure ledger
  ============  =================  ==========================

(rdp's measured ratio at that point is 0.377 — a 2.65x noise reduction;
advanced reaches 0.62x at k=60 and 0.34x at k=200.)

``basic`` and ``subexp`` are ``exact_basic``: their multiplier ratio is
the literal float 1.0 and the calibrated sigma tuple is never rescaled.
"""
from __future__ import annotations

from repro_torch.core import dp
from repro_torch.privacy.registry import Accountant, register


def _basic_per_round(eps: float, delta: float, k: int):
    return eps / k, delta / k


def _basic_multiplier(eps: float, delta: float, k: int) -> float:
    return dp.noise_multiplier(eps / k, delta / k)


def _basic_compose(eps_r: float, delta_r: float, k: int):
    return k * eps_r, k * delta_r


BASIC = register(Accountant(
    name="basic",
    per_round=_basic_per_round,
    multiplier=_basic_multiplier,
    compose=_basic_compose,
    exact_basic=True,
    doc="Dwork et al. sum composition: the historical eps/5 (eps/6 "
        "untrusted) split. The byte-identical default.",
))


def _advanced_per_round(eps: float, delta: float, k: int):
    return dp.invert_advanced(eps, delta, k)


def _advanced_multiplier(eps: float, delta: float, k: int) -> float:
    return dp.noise_multiplier(*dp.invert_advanced(eps, delta, k))


def _advanced_compose(eps_r: float, delta_r: float, k: int):
    # Audit direction: the better of basic and Cor 4.1 at slack = one
    # basic delta-budget (the standard "report at ~2x delta" convention).
    basic = (k * eps_r, k * delta_r)
    adv = dp.compose_advanced(eps_r, delta_r, k, slack=k * delta_r)
    return adv if adv[0] < basic[0] else basic


ADVANCED = register(Accountant(
    name="advanced",
    per_round=_advanced_per_round,
    multiplier=_advanced_multiplier,
    compose=_advanced_compose,
    doc="Kairouz-Oh-Viswanath Cor 4.1 INVERTED over a slack grid to "
        "calibrate per-round sigma, best-of with basic so it is never "
        "worse. Cor 4.1's sqrt(k) regime only beats the linear bound "
        "once k >~ 2 ln(1/delta) (~23 at delta=1e-5), so at the paper's "
        "k in {5, 6} it ties basic exactly and the gain appears at "
        "many-round training scale.",
))


def _rdp_per_round(eps: float, delta: float, k: int):
    # The standalone (eps_r, delta_r) one Gaussian release at the
    # calibrated multiplier satisfies (single-release tight conversion at
    # delta/k). Composing k of these under RDP certifies the total by
    # construction of the multiplier.
    mu = dp.calibrate_rdp_multiplier(eps, delta, k)
    delta_r = delta / k
    return dp.rdp_total_epsilon(mu, 1, delta_r), delta_r


def _rdp_multiplier(eps: float, delta: float, k: int) -> float:
    return dp.calibrate_rdp_multiplier(eps, delta, k)


def _rdp_compose(eps_r: float, delta_r: float, k: int):
    mu = dp.calibrate_rdp_multiplier(eps_r, delta_r, 1)
    return dp.rdp_total_epsilon(mu, k, k * delta_r), k * delta_r


RDP = register(Accountant(
    name="rdp",
    per_round=_rdp_per_round,
    multiplier=_rdp_multiplier,
    compose=_rdp_compose,
    doc="Gaussian-mechanism Renyi curves composed per order, converted "
        "with the tight RDP->(eps,delta) bound and optimized over the "
        "alpha grid. ~2.65x smaller per-round sigma than basic at the "
        "paper's (eps=5, delta=1e-5, k=6).",
))


def _subexp_failure_prob(p: int, n: int, gamma: float) -> float:
    return dp.mean_dp_failure_prob_subexp(p, n, gamma, 1.0, 1.0)


SUBEXP = register(Accountant(
    name="subexp",
    per_round=_basic_per_round,
    multiplier=_basic_multiplier,
    compose=_basic_compose,
    exact_basic=True,
    high_prob=True,
    failure_prob=_subexp_failure_prob,
    doc="The paper's sub-exponential high-probability mechanism (Lemma "
        "4.4): identical sigmas to basic, but the data-driven tail bound "
        "replaces any bounded-gradient clip, so mechanism-level DP holds "
        "only on the sensitivity event — EVERY transmission's failure "
        "probability is recorded in the ledger and union-bounded.",
))
