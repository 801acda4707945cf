"""repro_torch.analyze: privacy- and sync-safety static analysis of the
port — ``repro.analyze`` counterpart.

The paper's DP guarantee rests on invariants no test sees whole: every
transmission gets independent noise, every noise injection has a spend
record, and the transport wire is the only path to the aggregator. The
port carries them in torch idiom (``torch.Generator`` streams, hand
kernels launched through ctypes, eager steps on the card), so the
reference's rules, which know ``jax.random``, ``jax.jit`` and
``pallas_call``, cannot read it. This package holds the same layout with
the rules written anew:

  * ``registry``  — one :class:`Rule` entry per invariant;
  * ``callgraph`` — module parsing, name resolution, call-graph edges and
    step-reachability (functions reachable from the per-step roots
    declared in ``callgraph.STEP_ROOTS``);
  * ``rules``     — generator-seeding, wire-boundary, ledger-pairing,
    step-sync, kernel-launch, cache-key (``rules.REFERENCE_RULES`` maps
    each reference rule to its counterpart);
  * ``engine``    — orchestration, inline suppressions
    (``# repro-torch: allow(<rule>) — <reason>``), human + JSON reports;
  * ``cli``       — ``python -m repro_torch.analyze`` /
    ``repro-torch-analyze``.

It imports the standard library only.
"""
from repro_torch.analyze.engine import Report, analyze_paths
from repro_torch.analyze.registry import (Finding, Rule, get_rule, register,
                                          registered, unregister)

__all__ = ["analyze_paths", "Report", "Finding", "Rule", "register",
           "unregister", "get_rule", "registered"]
