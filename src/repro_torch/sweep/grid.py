"""Declarative scenario grids over the paper's experimental axes —
``repro/sweep/grid.py`` counterpart.

A ``Scenario`` is one point of the paper's §5 evaluation space — loss
family x Byzantine attack x robust aggregator x privacy budget eps x
machine count m x Byzantine fraction alpha x center-trust mode — plus the
bookkeeping needed to reproduce it exactly (data seed, replicate seeds).

``ScenarioGrid`` expands a Cartesian product of those axes into scenarios;
``group_scenarios`` buckets them by *group key*: the fields the reference
bakes into one compiled executable (shapes and static config). The port
keeps the same keys, ids and labels, so the two packages' artifacts diff
per scenario; its executor runs each scenario of a group as one
``protocol_rounds`` call.

A ``TrainScenario`` is one model-zoo training run: the same
five-transmission engine driving a few quasi-Newton steps of a reduced
zoo config. Its key leads with ``"zoo"``, so mixed sweeps bucket training
and protocol scenarios apart.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.agg import registered as registered_aggregators
from repro_torch.attacks import registered as registered_attacks
from repro_torch.attacks import resolve as resolve_attack
from repro_torch.configs.base import ProtocolConfig, TreeProtocolConfig
from repro_torch.privacy import registered as registered_accountants


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One protocol evaluation point. Field groups:

    group key (static in the reference's compiled executable):
        problem, m, n, p, reps, attack, aggregator, center_trust, K,
        trim_beta, gammas, lambda_s, tail, newton_steps, noiseless,
        accountant (the ledger semantics differ per accountant, so
        groups never mix them)
    dynamic (vary within a group):
        eps, delta, byz_frac, attack_factor, data_seed, rep_seeds
    data-only (select which arrays are fed):
        dataset, pair
    """
    problem: str = "logistic"          # loss family (core/losses.py)
    dataset: str = "synthetic"         # synthetic | digits
    m: int = 50                        # node machines (center is machine 0)
    n: int = 1000                      # samples per machine
    p: int = 10                        # parameter dimension
    eps: float = 30.0                  # total privacy budget
    delta: float = 0.05
    byz_frac: float = 0.0              # alpha: fraction of Byzantine machines
    attack: str = "scale"              # attacks registry name | "none"
    attack_factor: float = -3.0
    aggregator: str = "dcq"            # dcq | median | trimmed | geomedian | mean
    center_trust: str = "trusted"      # trusted | untrusted (paper §4.3)
    K: int = 10
    trim_beta: float = 0.2
    gammas: Tuple[float, ...] = (2.0, 2.0, 2.0, 2.0, 2.0)
    lambda_s: Optional[float] = None
    tail: str = "subexp"
    newton_steps: int = 25
    noiseless: bool = False
    accountant: str = "basic"          # privacy registry name
    reps: int = 5                      # Monte-Carlo replicates
    data_seed: int = 0
    # Explicit per-replicate seeds (tuple of ints, len == reps). None
    # derives deterministic seeds from the scenario id, so resumed sweeps
    # reproduce the same draws (sweep/data.py replicate_seeds).
    rep_seeds: Optional[Tuple[int, ...]] = None
    pair: Optional[Tuple[int, int]] = None   # digits dataset class pair

    def __post_init__(self):
        if self.rep_seeds is not None and len(self.rep_seeds) != self.reps:
            raise ValueError(
                f"rep_seeds has {len(self.rep_seeds)} entries for "
                f"reps={self.reps}")
        if self.dataset == "digits" and self.pair is None:
            raise ValueError("digits scenarios need a class `pair`")
        if self.aggregator not in registered_aggregators():
            # the aggregator registry is the source of truth: a newly
            # registered aggregator is immediately sweepable, a typo is
            # rejected before anything runs
            raise ValueError(
                f"unknown aggregator {self.aggregator!r}; registered: "
                f"{registered_aggregators()}")
        # canonicalize launcher aliases ("sign"/"noise") so group_key and
        # scenario_id are stable regardless of which name the caller used
        object.__setattr__(self, "attack", resolve_attack(self.attack))
        if self.attack not in registered_attacks():
            # same contract on the adversary axis: the attack registry
            # is the source of truth for sweepable threat models
            raise ValueError(
                f"unknown attack {self.attack!r}; registered: "
                f"{registered_attacks()}")
        if self.accountant not in registered_accountants():
            # and on the privacy axis: the accountant registry is the
            # source of truth for composition rules
            raise ValueError(
                f"unknown accountant {self.accountant!r}; registered: "
                f"{registered_accountants()}")

    # ------------------------------------------------------------- identity

    def canonical(self) -> Tuple:
        """Stable full-field tuple (dict ordering is field order).

        ``accountant`` is EXCLUDED at its default "basic" so every
        scenario id minted before the accountant axis existed — committed
        golden keys, resumable artifacts — is byte-unchanged; non-basic
        accountants hash in like any other field."""
        return tuple(sorted(
            (f.name, repr(getattr(self, f.name)))
            for f in dataclasses.fields(self)
            if not (f.name == "accountant"
                    and getattr(self, f.name) == "basic")))

    def scenario_id(self) -> str:
        """Human-readable id, unique via a canonical-field hash; stable
        across processes (used as the resume key in artifacts)."""
        h = hashlib.sha1(repr(self.canonical()).encode()).hexdigest()[:8]
        acct = "" if self.accountant == "basic" else f"-{self.accountant}"
        return (f"{self.dataset}-{self.problem}-m{self.m}-n{self.n}"
                f"-p{self.p}-eps{self.eps:g}-byz{self.byz_frac:g}"
                f"-{self.attack}-{self.aggregator}-{self.center_trust}"
                f"{acct}-{h}")

    def group_key(self) -> Tuple:
        """Static config + shapes: the reference compiles one executable
        per key; the port's executor runs and reports a group together."""
        return (self.problem, self.m, self.n, self.p, self.reps,
                self.attack, self.aggregator, self.center_trust, self.K,
                self.trim_beta, self.gammas, self.lambda_s, self.tail,
                self.newton_steps, self.noiseless, self.accountant)

    def protocol_config(self) -> ProtocolConfig:
        """This scenario's protocol config, its budget included."""
        return ProtocolConfig(
            K=self.K, eps=self.eps, delta=self.delta, gammas=self.gammas,
            lambda_s=self.lambda_s, tail=self.tail,
            aggregator=self.aggregator, trim_beta=self.trim_beta,
            center_trust=self.center_trust, newton_steps=self.newton_steps,
            noiseless=self.noiseless, accountant=self.accountant)

    def n_byzantine(self) -> int:
        return int(self.byz_frac * self.m)

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        # tuples -> lists happens in json anyway; keep plain dict
        return d


def scenario_from_json(d: Dict) -> "Scenario | TrainScenario":
    """A ``Scenario``, or a ``TrainScenario`` for a ``"kind": "train"``
    record, from its ``to_json`` record."""
    kw = dict(d)
    if kw.pop("kind", None) == "train":
        return TrainScenario(**kw)
    for key in ("gammas", "rep_seeds", "pair"):
        if kw.get(key) is not None:
            kw[key] = tuple(kw[key])
    return Scenario(**kw)


# ------------------------------------------------- model-zoo training points

@dataclasses.dataclass(frozen=True)
class TrainScenario:
    """One robust-DP quasi-Newton TRAINING run of a model-zoo config: the
    same five-transmission engine as :class:`Scenario`'s convex protocol
    (``core.protocol.protocol_tree_rounds``), driven for ``steps``
    optimizer steps over the arch's parameter tree (its reduced config).

    group key (static in the reference's compiled step):
        arch, steps, batch, seq, machines, aggregator, attack, hist,
        lr, local_lr, local_steps, tail, K, trim_beta, noiseless,
        accountant
    dynamic (vary within a group):
        eps/delta (as per-leaf sigma trees), byz_frac (as the mask),
        attack_factor, seed
    """
    arch: str = "xlstm-125m"           # repro_torch.configs zoo name
    steps: int = 3                     # optimizer steps (= protocol runs)
    batch: int = 8                     # global batch, split over machines
    seq: int = 16
    machines: int = 4
    eps: float = 0.0                   # per-step budget; <= 0 = noiseless
    delta: float = 0.05
    byz_frac: float = 0.0
    attack: str = "none"
    attack_factor: float = -3.0
    aggregator: str = "dcq_mad"        # aggregator registry name
    hist: int = 5                      # L-BFGS memory length
    lr: float = 0.3
    local_lr: float = 0.1
    local_steps: int = 1
    gamma: float = 2.0
    tail: str = "subexp"
    K: int = 10
    trim_beta: float = 0.2
    accountant: str = "basic"          # privacy registry name
    seed: int = 0

    def __post_init__(self):
        from repro_torch.configs import ARCHS
        if self.arch not in ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}; available: "
                             f"{ARCHS}")
        if self.batch % self.machines:
            raise ValueError(f"batch {self.batch} does not split over "
                             f"{self.machines} machines")
        if self.aggregator not in registered_aggregators():
            raise ValueError(
                f"unknown aggregator {self.aggregator!r}; registered: "
                f"{registered_aggregators()}")
        object.__setattr__(self, "attack", resolve_attack(self.attack))
        if self.attack not in registered_attacks():
            raise ValueError(
                f"unknown attack {self.attack!r}; registered: "
                f"{registered_attacks()}")
        if self.accountant not in registered_accountants():
            raise ValueError(
                f"unknown accountant {self.accountant!r}; registered: "
                f"{registered_accountants()}")

    # ------------------------------------------------------------- identity

    def canonical(self) -> Tuple:
        """As :meth:`Scenario.canonical`: ``accountant`` is left out at
        "basic", so ids stay stable."""
        return tuple(sorted(
            (f.name, repr(getattr(self, f.name)))
            for f in dataclasses.fields(self)
            if not (f.name == "accountant"
                    and getattr(self, f.name) == "basic")))

    def scenario_id(self) -> str:
        h = hashlib.sha1(repr(self.canonical()).encode()).hexdigest()[:8]
        acct = "" if self.accountant == "basic" else f"-{self.accountant}"
        return (f"zoo-{self.arch}-t{self.steps}-b{self.batch}"
                f"-s{self.seq}-m{self.machines}-eps{self.eps:g}"
                f"-byz{self.byz_frac:g}-{self.attack}-{self.aggregator}"
                f"{acct}-{h}")

    def group_key(self) -> Tuple:
        """Leads with "zoo"; eps rides as sigma trees, byz_frac as the mask
        and attack_factor as a scalar, so they stay out of the key."""
        return ("zoo", self.arch, self.steps, self.batch, self.seq,
                self.machines, self.aggregator, self.attack, self.hist,
                self.lr, self.local_lr, self.local_steps, self.tail,
                self.K, self.trim_beta, self.eps <= 0.0, self.accountant)

    def protocol_config(self) -> TreeProtocolConfig:
        """The group's engine config. eps is reduced to the noiseless flag
        (the executor hands each scenario's budget over as per-leaf sigma
        trees)."""
        return TreeProtocolConfig(
            hist=self.hist, lr=self.lr, local_lr=self.local_lr,
            local_steps=self.local_steps,
            eps=1.0 if self.eps > 0 else 0.0, delta=self.delta,
            gammas=(self.gamma,) * 5, tail=self.tail,
            aggregator=self.aggregator, K=self.K,
            trim_beta=self.trim_beta, accountant=self.accountant)

    def n_byzantine(self) -> int:
        return int(self.byz_frac * self.machines)

    def n_per_machine(self) -> int:
        return self.batch // self.machines

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["kind"] = "train"
        return d


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """Cartesian product over the paper's scenario axes. Axes are tuples;
    scalars are shared by every expanded scenario."""
    problems: Tuple[str, ...] = ("logistic",)
    attacks: Tuple[str, ...] = ("scale",)
    aggregators: Tuple[str, ...] = ("dcq",)
    eps_grid: Tuple[float, ...] = (30.0,)
    m_grid: Tuple[int, ...] = (50,)
    byz_fracs: Tuple[float, ...] = (0.0,)
    center_trusts: Tuple[str, ...] = ("trusted",)
    attack_factors: Tuple[float, ...] = (-3.0,)
    accountants: Tuple[str, ...] = ("basic",)
    # shared scalars
    n: int = 1000
    p: int = 10
    reps: int = 5
    delta: float = 0.05
    K: int = 10
    trim_beta: float = 0.2
    gammas: Tuple[float, ...] = (2.0, 2.0, 2.0, 2.0, 2.0)
    lambda_s: Optional[float] = None
    tail: str = "subexp"
    newton_steps: int = 25
    noiseless: bool = False
    data_seed: int = 0
    # "shared": every scenario reuses data_seed per (m, problem);
    # "per-m": seed = data_seed + m (the mrse_vs_m convention, fresh data
    # per machine count).
    data_seed_mode: str = "shared"

    def size(self) -> int:
        return (len(self.problems) * len(self.attacks)
                * len(self.aggregators) * len(self.eps_grid)
                * len(self.m_grid) * len(self.byz_fracs)
                * len(self.center_trusts) * len(self.attack_factors)
                * len(self.accountants))

    def expand(self) -> List[Scenario]:
        if self.data_seed_mode not in ("shared", "per-m"):
            raise ValueError(f"unknown data_seed_mode {self.data_seed_mode!r}")
        out = []
        for (prob, attack, agg, eps, m, byz, trust, factor, acct) in \
                itertools.product(self.problems, self.attacks,
                                  self.aggregators, self.eps_grid,
                                  self.m_grid, self.byz_fracs,
                                  self.center_trusts, self.attack_factors,
                                  self.accountants):
            seed = (self.data_seed + m if self.data_seed_mode == "per-m"
                    else self.data_seed)
            out.append(Scenario(
                problem=prob, m=m, n=self.n, p=self.p, eps=float(eps),
                delta=self.delta, byz_frac=byz, attack=attack,
                attack_factor=factor, aggregator=agg, center_trust=trust,
                K=self.K, trim_beta=self.trim_beta, gammas=self.gammas,
                lambda_s=self.lambda_s, tail=self.tail,
                newton_steps=self.newton_steps, noiseless=self.noiseless,
                accountant=acct, reps=self.reps, data_seed=seed))
        return out

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


def group_scenarios(scenarios: Iterable[Scenario]
                    ) -> "Dict[Tuple, List[Scenario]]":
    """Bucket scenarios by group key, preserving first-seen order."""
    groups: Dict[Tuple, List[Scenario]] = {}
    for s in scenarios:
        groups.setdefault(s.group_key(), []).append(s)
    return groups


def group_label(key: Tuple) -> str:
    """Short human-readable tag for a group (artifact/timing records): the
    reference's label. The accountant rides last in both key layouts
    (after the noiseless flag) and is tagged only when non-basic."""
    if key[0] == "zoo":
        _, arch, steps, batch, seq, machines, agg, attack = key[:8]
        tag = (f"zoo-{arch}-t{steps}-b{batch}-s{seq}-m{machines}"
               f"-{attack}-{agg}")
    else:
        problem, m, n, p, reps, attack, agg, trust = key[:8]
        tag = f"{problem}-m{m}-n{n}-p{p}-r{reps}-{attack}-{agg}-{trust}"
    if key[-2]:
        tag += "-noiseless"
    if key[-1] != "basic":
        tag += f"-{key[-1]}"
    return tag
