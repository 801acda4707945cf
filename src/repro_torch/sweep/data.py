"""Scenario -> tensors: data builders, Byzantine masks, replicate draws,
and per-scenario metrics — ``repro/sweep/data.py`` counterpart. Kept
separate from the executor so presets and tests can reproduce exactly
what a scenario feeds the protocol core.

Replicate draws: the reference derives one PRNG key per replicate (from
``rep_seeds``, else from a sha1 of the scenario id). The port derives one
seed per replicate the same way (:func:`replicate_seeds`) and draws each
replicate's standard normals from its own ``torch.Generator`` on the
device (:func:`replicate_draws`), so a replicate's draws depend on its
seed alone: a resumed sweep, a chunked group and a ``--fast`` cut (which
truncates ``rep_seeds``) repeat them on the same device.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch.attacks import needs_key
from repro_torch.core.protocol import monte_carlo_mrse, transmission_names
from repro_torch.data.synthetic import (digits_like_dataset, make_shards,
                                        target_theta)
from repro_torch.sweep.grid import Scenario

#: held-out rows for the digits pipeline (screening + test, table1 layout)
_DIGITS_SCREEN = 4000
_DIGITS_TEST = 4000

Draws = Optional[Dict[str, torch.Tensor]]


def byz_mask(scenario: Scenario, device) -> torch.Tensor:
    """(m,) bool mask over NODE machines: the first floor(byz_frac * m)
    are Byzantine (the deterministic layout every benchmark preset uses;
    machine order is exchangeable for i.i.d. shards)."""
    mask = torch.zeros((scenario.m,), dtype=torch.bool, device=device)
    mask[:scenario.n_byzantine()] = True
    return mask


def replicate_seeds(scenario: Scenario) -> Tuple[int, ...]:
    """One seed per replicate: ``rep_seeds`` when given, else the first
    four bytes of the sha1 of the scenario id (the reference's key seed)
    plus r times a 32-bit odd stride, modulo 2^32 (a CPU generator keeps
    32 bits of its seed), for replicate r."""
    if scenario.rep_seeds is not None:
        return tuple(scenario.rep_seeds)
    sid_hash = int.from_bytes(
        hashlib.sha1(scenario.scenario_id().encode()).digest()[:4], "big")
    return tuple((sid_hash + r * 0x9E3779B9) % (1 << 32)
                 for r in range(scenario.reps))


def replicate_draws(scenario: Scenario, device) -> Tuple[Draws, Draws]:
    """``(noise, attack_noise)`` for ``protocol_rounds(reps=R)``: standard
    normals keyed by transmission name, ``(R, rows, p)``. Replicate r's
    generator (seeded from :func:`replicate_seeds`) draws, transmission by
    transmission in order, the noise and then the attack's draws, as
    ``protocol_rounds`` would from one generator. A table nothing reads
    (a noiseless run, an attack that draws nothing) is None."""
    cfg = scenario.protocol_config()
    names = transmission_names(cfg)
    with_noise = not cfg.noiseless
    with_attack = scenario.attack != "none" and needs_key(scenario.attack)
    m, p = scenario.m, scenario.p
    noise = {name: [] for name in names}
    attack = {name: [] for name in names}
    for seed in replicate_seeds(scenario):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        for name in names:
            shape = (m if name == "R2b var" else m + 1, p)
            if with_noise:
                noise[name].append(torch.randn(shape, generator=g,
                                               device=device))
            if with_attack:
                attack[name].append(torch.randn(shape, generator=g,
                                                device=device))

    def stacked(table, used):
        return {k: torch.stack(v) for k, v in table.items()} if used \
            else None
    return stacked(noise, with_noise), stacked(attack, with_attack)


def screen_features(X: torch.Tensor, y: torch.Tensor, k: int
                    ) -> torch.Tensor:
    """Lasso-style screening stand-in: top-k |two-sample t| features
    (shared with the Table 1 benchmark)."""
    mu1 = X[y == 1].mean(0)
    mu0 = X[y == 0].mean(0)
    s = X.std(0, correction=0) + 1e-9
    t = (mu1 - mu0).abs() / s
    return torch.argsort(-t, stable=True)[:k]


def build_data(scenario: Scenario, device
               ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """(X, y, aux) on ``device``: X (m+1, n, p), y (m+1, n); aux carries
    what the metric needs — the target parameter for synthetic designs,
    the held-out test split for digits. Synthetic shards come from a
    generator on the device seeded with ``data_seed``."""
    if scenario.dataset == "synthetic":
        g = torch.Generator(device=device)
        g.manual_seed(scenario.data_seed)
        X, y = make_shards(g, scenario.problem, scenario.m, scenario.n,
                           scenario.p)
        return X, y, {"target": target_theta(scenario.p, device)}
    if scenario.dataset == "digits":
        m, n, k = scenario.m, scenario.n, scenario.p
        n_total = (m + 1) * n + _DIGITS_TEST
        X, y, _ = digits_like_dataset(scenario.data_seed, n_total,
                                      pair=scenario.pair, device=device)
        cols = screen_features(X[:_DIGITS_SCREEN], y[:_DIGITS_SCREEN], k)
        Xs = X[:, cols]
        Xtr = Xs[:(m + 1) * n].reshape(m + 1, n, -1)
        ytr = y[:(m + 1) * n].reshape(m + 1, n)
        return Xtr, ytr, {"Xte": Xs[-_DIGITS_TEST:],
                          "yte": y[-_DIGITS_TEST:]}
    raise ValueError(f"unknown dataset {scenario.dataset!r}")


def compute_metrics(scenario: Scenario, thetas: Dict[str, torch.Tensor],
                    aux: Dict) -> Dict[str, float]:
    """Per-scenario summary metrics from the (reps, p) estimator stacks."""
    if scenario.dataset == "synthetic":
        t = aux["target"]
        return {f"mrse_{name}": monte_carlo_mrse(thetas[name], t)
                for name in ("cq", "os", "qn")}
    if scenario.dataset == "digits":
        Xte, yte = aux["Xte"], aux["yte"]
        preds = (torch.sigmoid(thetas["qn"] @ Xte.T) > 0.5).float()
        return {"accuracy": float((preds == yte[None, :]).float().mean())}
    raise ValueError(f"unknown dataset {scenario.dataset!r}")
