"""``repro_torch.api`` — the public surface of the port, ``repro.api``
counterpart (the same names and entry-point parameters; the reference's
``tests/test_api.py`` snapshots them).

  * :func:`run_protocol`     — one replicate of the paper's Algorithm 1
    (DP quasi-Newton robust estimation) over pre-sharded data;
  * :func:`run_monte_carlo`  — batched replicates on shared data;
  * :func:`run_sweep`        — the scenario sweep over the paper's grid,
    by preset name or scenario list;
  * :func:`serve`            — the streaming aggregation service;

plus the registry views and the config/result types these consume.

Where the reference takes a PRNG key (``key``, ``keys``), the port takes
a ``torch.Generator`` (None: one seeded with ``seed`` on the device).
Everything runs on the card unless a ``device="cpu"`` keyword argument
says otherwise. ``run_sweep(mesh=)`` spreads every scenario's machines
over the ranks of a machine mesh (``launch.cli.machine_mesh``), and
``serve(sharding=)`` splits the service's ring buffer over them.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch import agg as _agg
from repro_torch import attacks as _attacks
from repro_torch import resolve_device
from repro_torch.configs.base import ProtocolConfig
from repro_torch.core.losses import MEstimationProblem, get_problem
from repro_torch.core.protocol import DPQNProtocol, ProtocolResult
from repro_torch.serve import (AggregationService, FlushPolicy, RingBuffer,
                               ServeConfig)

__all__ = [
    "run_protocol", "run_monte_carlo", "run_sweep", "serve",
    "registered_aggregators", "registered_attacks",
    "ProtocolConfig", "ProtocolResult", "DPQNProtocol",
    "MEstimationProblem", "get_problem",
    "AggregationService", "ServeConfig", "FlushPolicy", "RingBuffer",
]

def _protocol(problem, cfg, kwargs) -> DPQNProtocol:
    prob = get_problem(problem) if isinstance(problem, str) else problem
    return DPQNProtocol(prob, cfg if cfg is not None else ProtocolConfig(),
                        device=kwargs.pop("device", None))


def _generator(gen: Optional[torch.Generator], seed: int,
               device) -> torch.Generator:
    return gen if gen is not None else \
        torch.Generator(device=device).manual_seed(seed)


def run_protocol(X, y, problem: Any = "logistic",
                 cfg: Optional[ProtocolConfig] = None,
                 key: Optional[torch.Generator] = None, seed: int = 0,
                 **kwargs) -> ProtocolResult:
    """One replicate of Algorithm 1 over pre-sharded data.

    ``X``: (m+1, n, p), ``y``: (m+1, n), machine 0 the central processor.
    ``problem`` is a registered loss name or an :class:`MEstimationProblem`;
    ``cfg`` defaults to the paper's :class:`ProtocolConfig`; ``key`` is the
    generator of the draws. Other keyword arguments (``byz_mask``,
    ``attack``, ``attack_factor``, ``theta0``, ``noise``, ..., and
    ``device``) go to :meth:`DPQNProtocol.run`."""
    proto = _protocol(problem, cfg, kwargs)
    gen = _generator(key, seed, proto.device)
    return proto.run(X, y, generator=gen, **kwargs)


def run_monte_carlo(X, y, reps: int = 100, problem: Any = "logistic",
                    cfg: Optional[ProtocolConfig] = None,
                    keys: Optional[torch.Generator] = None, seed: int = 0,
                    **kwargs):
    """``reps`` replicates of Algorithm 1 at once on shared data: a
    ``ProtocolArrays`` whose every field has a leading replicate axis
    (``theta_qn``: (reps, p)). ``keys`` is the generator every replicate's
    draws come from."""
    proto = _protocol(problem, cfg, kwargs)
    gen = _generator(keys, seed, proto.device)
    return proto.run_monte_carlo(reps, X, y, generator=gen, **kwargs)


def run_sweep(scenarios: Any = "smoke", fast: bool = False,
              artifact_path: Optional[str] = None, **kwargs) -> dict:
    """Run a scenario sweep and return its artifact dict. ``scenarios`` is
    a preset name (``repro_torch.sweep.PRESETS``) or an iterable of
    ``Scenario``; ``fast=True`` runs the reduced-replicate variant. Other
    keyword arguments (``device``, ``resume``, ``chunk_size``, ``mesh``,
    ...) go to ``repro_torch.sweep.run_scenarios``."""
    from repro_torch import sweep as _sweep
    scens = _sweep.build_preset(scenarios) if isinstance(scenarios, str) \
        else list(scenarios)
    if fast:
        scens = _sweep.fast_variant(scens)
    return _sweep.run_scenarios(scens, artifact_path=artifact_path, **kwargs)


def serve(theta: Any, cfg: Optional[ServeConfig] = None,
          policy: Optional[FlushPolicy] = None,
          sharding: Optional[Any] = None,
          **cfg_kwargs) -> AggregationService:
    """Stand up a streaming aggregation service around ``theta`` (a tensor
    or a tree). Pass a :class:`ServeConfig` or its fields as keyword
    arguments (``serve(theta, method="median", capacity=4096, eps=1.0)``);
    ``device`` places the service. ``sharding`` (a 1-D machine mesh,
    ``launch.cli.machine_mesh``) splits the ring buffer's capacity axis
    over its ranks, every rank fed the same arrivals."""
    device = resolve_device(cfg_kwargs.pop("device", None))
    if cfg is not None and cfg_kwargs:
        raise ValueError("pass either cfg or ServeConfig fields, not both")
    if cfg is None:
        cfg = ServeConfig(**cfg_kwargs)
    return AggregationService(theta, cfg, policy=policy, device=device,
                              sharding=sharding)


def registered_aggregators() -> tuple:
    """Names of every registered robust-aggregation rule."""
    return _agg.registered()


def registered_attacks() -> tuple:
    """Names of every registered Byzantine attack."""
    return _attacks.registered()
