"""Named scenario grids: the paper's §5 evaluation as sweep presets —
``repro/sweep/presets.py`` counterpart, the same scenarios and ids.

Builders are parameterized like the reference's (``rep_seeds`` name each
replicate's seed); the CLI exposes them through ``PRESETS``:

  smoke      2 losses x 2 attacks x 2 aggregators x 2 eps, plus one
             registry-path group (alie x dcq)
  fig-eps    Figures 1/2/4/5: MRSE vs eps, normal + 10% Byzantine
  fig-m      Figures 3/6:     MRSE vs machine count m
  table1     Table 1 stand-in: digit-pair accuracy vs eps (+ Byzantine)
  untrusted  §4.3 sensitivity: center_trust x EVERY registered aggregator
             (the grid is driven by the aggregator registry — a newly
             registered aggregator appears in this preset automatically)
  attack-sensitivity
             threat-model grid: EVERY registered attack x its declared
             factor grid x {dcq, median, trimmed} x byz_frac {0.1, 0.2}
             (driven by the attack registry — a newly registered
             attack appears here automatically; one group per
             (attack, aggregator))
  paper      fig-eps + fig-m + table1, in one artifact
  zoo-smoke  model-zoo training: short robust-DP quasi-Newton runs (the
             same five-transmission engine) on one reduced config per
             family, a clean-mean baseline and a two-budget DP group
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.agg import registered as registered_aggregators
from repro_torch.attacks import get_attack
from repro_torch.attacks import registered as registered_attacks
from repro_torch.sweep.grid import Scenario, ScenarioGrid, TrainScenario

#: Figure 1-3 default privacy budgets (paper §5.1)
EPS_GRID = (4.0, 10.0, 20.0, 30.0, 50.0)
#: Table 1 digit pairs -> screened feature count (paper §5.2)
TABLE1_PAIRS: Dict[Tuple[int, int], int] = {(8, 9): 8, (6, 8): 5, (6, 9): 5}


# ------------------------------------------------------------------- smoke

def smoke_scenarios() -> List[Scenario]:
    """Smoke grid: 2 losses x 2 attacks x 2 aggregators x 2 eps = 16
    scenarios in 8 groups, plus one registry-path group (alie x dcq,
    2 eps) so the omniscient attack path runs too.

    m = 7 (m+1 = 8 machine rows, center included); byz_frac 0.15 keeps
    one Byzantine machine."""
    grid = ScenarioGrid(
        problems=("logistic", "poisson"),
        attacks=("scale", "signflip"),
        aggregators=("dcq", "median"),
        eps_grid=(10.0, 30.0),
        m_grid=(7,), byz_fracs=(0.15,),
        n=200, p=5, reps=2)
    alie = ScenarioGrid(
        problems=("logistic",),
        attacks=("alie",), attack_factors=(1.0,),
        aggregators=("dcq",),
        eps_grid=(10.0, 30.0),
        m_grid=(7,), byz_fracs=(0.15,),
        n=200, p=5, reps=2)
    return grid.expand() + alie.expand()


# --------------------------------------------------------------- zoo-smoke

#: one reduced config per model family the protocol engine drives
#: (ssm/xlstm, dense, moe, hybrid mamba+attn)
ZOO_SMOKE_ARCHS: Tuple[str, ...] = (
    "xlstm-125m", "glm4-9b", "qwen3-moe-30b-a3b", "zamba2-7b")


def zoo_smoke_scenarios() -> List[TrainScenario]:
    """Model-zoo training smoke: the same five-transmission engine that
    makes the convex figures drives short robust QN training runs on one
    reduced config per family, plus (on xlstm) a clean-mean baseline and
    two DP budgets that share one group."""
    common = dict(steps=2, batch=8, seq=16, machines=4, lr=0.3)
    out = [TrainScenario(arch=arch, aggregator="dcq_mad", attack="signflip",
                         byz_frac=0.25, **common)
           for arch in ZOO_SMOKE_ARCHS]
    # the clean mean baseline (the no-defense configuration)
    out.append(TrainScenario(arch="xlstm-125m", aggregator="mean",
                             **common))
    # two per-step budgets in one group (per-leaf sigma trees)
    out += [TrainScenario(arch="xlstm-125m", aggregator="dcq_mad",
                          attack="signflip", byz_frac=0.25, eps=eps,
                          **common)
            for eps in (5.0, 50.0)]
    return out


# ------------------------------------------------- Figures 1/2/4/5 (vs eps)

def fig_eps_scenarios(problem: str = "logistic", m: int = 50, n: int = 1000,
                      p: int = 10, reps: int = 5, byz_frac: float = 0.0,
                      eps_grid: Tuple[float, ...] = EPS_GRID,
                      seed: int = 0) -> List[Scenario]:
    """One MRSE-vs-eps curve; replicate r of each eps point has seed
    1000*eps + r (the reference's historical key schedule)."""
    return [Scenario(
        problem=problem, m=m, n=n, p=p, eps=float(eps), delta=0.05,
        byz_frac=byz_frac, reps=reps, data_seed=seed,
        rep_seeds=tuple(int(1000 * eps) + r for r in range(reps)))
        for eps in eps_grid]


def fig_eps_reference(problem: str = "logistic", m: int = 50, n: int = 1000,
                      p: int = 10, byz_frac: float = 0.0,
                      seed: int = 0) -> Scenario:
    """The noiseless quasi-Newton reference line (replicate seed 9)."""
    return Scenario(problem=problem, m=m, n=n, p=p, noiseless=True,
                    byz_frac=byz_frac, reps=1, data_seed=seed,
                    rep_seeds=(9,))


# ----------------------------------------------------- Figures 3/6 (vs m)

def fig_m_scenarios(problem: str = "logistic", n: int = 500, p: int = 10,
                    m_grid: Tuple[int, ...] = (10, 20, 40, 80),
                    reps: int = 4, byz_frac: float = 0.0, eps: float = 30.0,
                    seed: int = 0) -> List[Scenario]:
    """One MRSE-vs-m curve: fresh data per machine count (seed + m),
    replicate seeds 10*m + r — the reference's mrse_vs_m schedule."""
    return [Scenario(
        problem=problem, m=m, n=n, p=p, eps=eps, delta=0.05,
        byz_frac=byz_frac, reps=reps, data_seed=seed + m,
        rep_seeds=tuple(10 * m + r for r in range(reps)))
        for m in m_grid]


# ------------------------------------------------ untrusted center (§4.3)

def untrusted_scenarios(eps_grid: Tuple[float, ...] = (10.0, 30.0),
                        m: int = 10, n: int = 400, p: int = 5,
                        reps: int = 3, byz_frac: float = 0.1
                        ) -> List[Scenario]:
    """Center-trust x aggregator grid over every registered aggregator.

    The aggregator axis is read from the aggregator registry, so
    ``register(...)``-ing a new rule makes it sweepable here with no
    preset change. Each (aggregator, trust) pair is one group."""
    grid = ScenarioGrid(
        problems=("logistic",),
        attacks=("scale",),
        aggregators=registered_aggregators(),
        eps_grid=eps_grid,
        m_grid=(m,), byz_fracs=(0.0, byz_frac),
        center_trusts=("trusted", "untrusted"),
        n=n, p=p, reps=reps)
    return grid.expand()


# --------------------------------------- attack-factor sensitivity (§5.1)

#: aggregators the attack grid stresses (the paper's estimator + the two
#: Yin-style robust baselines the related work attacks hardest)
ATTACK_AGGREGATORS: Tuple[str, ...] = ("dcq", "median", "trimmed")


def attack_sensitivity_scenarios(
        aggregators: Tuple[str, ...] = ATTACK_AGGREGATORS,
        byz_fracs: Tuple[float, ...] = (0.1, 0.2),
        m: int = 10, n: int = 300, p: int = 5, reps: int = 3,
        eps: float = 30.0) -> List[Scenario]:
    """Threat-model sensitivity grid, driven by the attack registry.

    EVERY registered attack with a non-empty ``factor_grid`` x its
    declared factors x ``aggregators`` x ``byz_fracs``. attack_factor and
    byz_frac are dynamic fields, so the grid has one group per (attack,
    aggregator) pair — ``register(...)``-ing a new attack makes it
    sweepable here with no preset change."""
    out: List[Scenario] = []
    for attack in registered_attacks():
        factors = get_attack(attack).factor_grid
        if not factors:                      # e.g. "none": nothing to sweep
            continue
        for agg in aggregators:
            out += [Scenario(
                problem="logistic", m=m, n=n, p=p, eps=eps, delta=0.05,
                byz_frac=byz, attack=attack, attack_factor=float(factor),
                aggregator=agg, reps=reps)
                for factor in factors for byz in byz_fracs]
    return out


# --------------------------------------------------------- Table 1 (digits)

def table1_scenarios(pair: Tuple[int, int], n_features: int,
                     eps_grid: Tuple[float, ...] = (5.0, 10.0, 20.0, 30.0),
                     byz_eps: Tuple[float, ...] = (30.0,),
                     m: int = 10, n_per_machine: int = 1000,
                     seed: int = 0, reps: int = 3) -> List[Scenario]:
    """One digit pair: clean accuracy across ``eps_grid`` plus Byzantine
    points at ``byz_eps`` (paper: +3x scaling attack, gamma = 0.5)."""
    def scen(eps: float, byz: bool) -> Scenario:
        return Scenario(
            problem="logistic", dataset="digits", pair=pair,
            m=m, n=n_per_machine, p=n_features, eps=float(eps), delta=0.05,
            byz_frac=0.1 if byz else 0.0, attack="scale", attack_factor=3.0,
            gammas=(0.5,) * 5, reps=reps, data_seed=seed,
            rep_seeds=tuple(seed + 1 + 1000 * r for r in range(reps)))
    return ([scen(eps, False) for eps in eps_grid]
            + [scen(eps, True) for eps in byz_eps])


# ---------------------------------------------------------------- registry

def _build_smoke() -> List[Scenario]:
    return smoke_scenarios()


def _build_fig_eps() -> List[Scenario]:
    out: List[Scenario] = []
    for problem in ("logistic", "poisson"):
        for byz in (0.0, 0.1):
            out += fig_eps_scenarios(problem, byz_frac=byz)
            out.append(fig_eps_reference(problem, byz_frac=byz))
    return out


def _build_fig_m() -> List[Scenario]:
    out: List[Scenario] = []
    for byz in (0.0, 0.1):
        out += fig_m_scenarios(byz_frac=byz)
    return out


def _build_table1() -> List[Scenario]:
    out: List[Scenario] = []
    for pair, k in TABLE1_PAIRS.items():
        out += table1_scenarios(pair, k)
    return out


def _build_untrusted() -> List[Scenario]:
    return untrusted_scenarios()


def _build_attack_sensitivity() -> List[Scenario]:
    return attack_sensitivity_scenarios()


def _build_paper() -> List[Scenario]:
    return _build_fig_eps() + _build_fig_m() + _build_table1()


PRESETS = {
    "smoke": _build_smoke,
    "zoo-smoke": zoo_smoke_scenarios,
    "fig-eps": _build_fig_eps,
    "fig-m": _build_fig_m,
    "table1": _build_table1,
    "untrusted": _build_untrusted,
    "attack-sensitivity": _build_attack_sensitivity,
    "paper": _build_paper,
}


def build_preset(name: str) -> List[Scenario]:
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()


def fast_variant(scenarios: List[Scenario], reps: int = 2) -> List[Scenario]:
    """Reduced-replicate copy of a preset (a smoke of the full figures).
    Explicit rep_seeds are truncated to keep per-replicate
    reproducibility; training scenarios are cut to ``reps`` steps
    instead."""
    out = []
    for s in scenarios:
        if isinstance(s, TrainScenario):
            out.append(dataclasses.replace(s, steps=min(reps, s.steps)))
            continue
        r = min(reps, s.reps)
        seeds = s.rep_seeds[:r] if s.rep_seeds is not None else None
        out.append(dataclasses.replace(s, reps=r, rep_seeds=seeds))
    return out
