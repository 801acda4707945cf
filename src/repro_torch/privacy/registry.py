"""Privacy-accountant registry: one entry per composition/calibration rule
— ``repro/privacy/registry.py`` counterpart.

The paper's noise calibration (Thms 4.4/4.5) splits the total (eps, delta)
evenly over the protocol's transmissions — basic composition, Remark 4.5.
That split is the only knob every sigma in the codebase hangs off, so a
sharper accountant is worth real noise reduction at fixed total budget.
This registry is the single place accounting rules live, mirroring
``repro_torch.agg``/``repro_torch.attacks``: an :class:`Accountant`
bundles the three directions an accounting rule is used in —

  * ``per_round``   — invert the composition: the per-transmission
    (eps_r, delta_r) this rule certifies for a k-fold run at total
    (eps, delta). This is what the spend ledger records.
  * ``multiplier``  — calibrate the noise: the per-round noise multiplier
    (the paper's Delta factor) the rule buys at that budget. Sigma scaling
    everywhere routes through the RATIO of this to the basic entry
    (:func:`multiplier_ratio`), so ``basic`` stays byte-identical by
    construction — the ratio is the exact float ``1.0`` and the basic
    sigma tuple is never touched.
  * ``compose``     — the audit direction: total (eps, delta) certified
    for k rounds at a given per-round budget (monotonicity tests compare
    accountants this way).

Registering a new accountant makes it immediately sweepable
(``Scenario.accountant`` validates against this registry and the sweep
CLI's ``--accountant`` offers it).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Accountant:
    """One privacy-composition rule.

    ``per_round(eps, delta, k)`` -> (eps_r, delta_r);
    ``multiplier(eps, delta, k)`` -> per-round noise multiplier (float);
    ``compose(eps_r, delta_r, k)`` -> (eps_total, delta_total).
    All three take Python floats — the non-basic entries invert their
    composition by bisection on the host; the sweep executor calibrates
    per scenario, exactly where the basic sigmas are already computed.
    """
    name: str
    per_round: Callable[[float, float, int], Tuple[float, float]]
    multiplier: Callable[[float, float, int], float]
    compose: Callable[[float, float, int], Tuple[float, float]]
    #: True when per-round sigma is identical to basic by construction:
    #: :func:`multiplier_ratio` returns the exact float 1.0 without any
    #: arithmetic, so calibration skips scaling and stays byte-identical.
    exact_basic: bool = False
    #: True for high-probability mechanisms: mechanism-level DP holds only
    #: on the tail-bound sensitivity event, whose failure probability must
    #: be recorded in the ledger.
    high_prob: bool = False
    #: ``failure_prob(p, n, gamma)`` -> per-transmission sensitivity
    #: failure probability (Lemma 4.4), or None when the rule makes no
    #: high-probability claim of its own.
    failure_prob: Optional[Callable[[int, int, float], float]] = None
    doc: str = ""


_REGISTRY: Dict[str, Accountant] = {}


def register(acct: Accountant) -> Accountant:
    """Register (or replace) an accountant under ``acct.name``."""
    _REGISTRY[acct.name] = acct
    return acct


def get_accountant(name: str) -> Accountant:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown accountant {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered() -> Tuple[str, ...]:
    """Registered accountant names, sorted."""
    return tuple(sorted(_REGISTRY))


def resolve(name: Optional[str]) -> str:
    """Validate ``name`` against the registry (None -> the default
    ``"basic"``), returning the canonical name."""
    if name is None:
        return "basic"
    return get_accountant(name).name


def multiplier_ratio(name: str, eps, delta, k: int) -> float:
    """Per-round noise-multiplier ratio of accountant ``name`` vs basic
    composition at total budget (eps, delta) over ``k`` transmissions.

    Every sigma path scales the BASIC calibration by this ratio, so the
    byte-parity contract is structural: ``exact_basic`` accountants return
    the literal ``1.0`` (no float math; a tensor budget is fine) and
    callers skip the multiply entirely. Non-basic accountants bisect on
    the host and therefore require Python-number budgets: a tensor (on any
    device) raises ``TypeError`` rather than being synchronised to the
    host behind the caller's back.
    """
    acct = get_accountant(name)
    if acct.exact_basic:
        return 1.0
    if not (isinstance(eps, (int, float)) and isinstance(delta, (int, float))):
        raise TypeError(
            f"accountant {acct.name!r} calibrates by bisection on the host; "
            "eps/delta must be Python numbers here, not tensors — compute "
            "sigma_base per scenario on the host (the sweep executor "
            "already does)")
    basic = get_accountant("basic")
    return acct.multiplier(eps, delta, k) / basic.multiplier(eps, delta, k)
