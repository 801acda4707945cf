"""Clean ledger pairing: the noise site's module records its spend."""
from repro_torch.core import dp
from repro_torch.core.transport import wire_aggregate, wire_noise


def accounted_transmission(gen, values, sigma, acct: dp.PrivacyAccountant):
    noisy = wire_noise(gen, values, sigma)
    acct.spend("R1 theta", 1.0, 0.01, sigma)
    return wire_aggregate(noisy, "median")
