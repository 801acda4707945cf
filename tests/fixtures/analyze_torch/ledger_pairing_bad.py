"""Seeded ledger-pairing violation: DP noise injected with no spend
record anywhere in the caller scope."""
from repro_torch.core.transport import wire_aggregate, wire_noise


def unaccounted_transmission(gen, values, sigma):
    noisy = wire_noise(gen, values, sigma)   # VIOLATION: no spend record
    return wire_aggregate(noisy, "median")
