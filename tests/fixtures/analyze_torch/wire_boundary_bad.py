"""Seeded wire-boundary violations: raw aggregation, a raw kernel call
and a raw attack outside the transport layer."""
from repro_torch import attacks
from repro_torch.agg import aggregate
from repro_torch.agg.kernel import ostat


def raw_aggregate(values):
    return aggregate(values, "median")                 # VIOLATION


def raw_kernel(values):
    return ostat(values, "median")                     # VIOLATION


def raw_attack(values, mask, gen):
    return attacks.apply_attack(values, mask, "scale", -3.0, gen)  # VIOLATION
