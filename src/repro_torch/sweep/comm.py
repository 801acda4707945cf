"""Communication/budget cost model (paper §1.2(1)/§6) of the sweep
artifact — ``repro/sweep/comm.py`` counterpart.

Bytes-per-machine and per-transmission privacy budget for the paper's
quasi-Newton protocol and the two strategies it argues against, at equal
total (eps, delta):

  quasi-Newton (Alg 1): n_tx p-vectors (5 trusted / 6 untrusted — the
                        extra "R2b var" vector is transmitted too)
  Newton (Huang&Huo):   1 p-vector + p + p^2 (full Hessian)
  GD (Jordan et al.):   T p-vectors (T rounds)

The sweep executor stamps :func:`comm_record` into every scenario record
(artifact schema v2), so transmission cost rides the same versioned
artifact as MRSE and the privacy spend.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ProtocolConfig
from repro_torch.core.protocol import n_transmissions, round_budget

#: wire width of one transmitted scalar (fp32)
BYTES_PER_SCALAR = 4


def qn_bytes_per_machine(p: int, cfg: ProtocolConfig) -> int:
    """Algorithm 1 payload per node machine: one p-vector per DP
    transmission (including the untrusted-center variance vector)."""
    return BYTES_PER_SCALAR * n_transmissions(cfg) * p


def newton_bytes_per_machine(p: int) -> int:
    """Distributed one-step Newton: theta + gradient + full p x p Hessian."""
    return BYTES_PER_SCALAR * (2 * p + p * p)


def gd_bytes_per_machine(p: int, rounds: int) -> int:
    """Multi-round distributed GD: one p-vector per round."""
    return BYTES_PER_SCALAR * p * rounds


def comm_record(p: int, cfg: ProtocolConfig) -> Dict:
    """The per-scenario transmission-cost record stamped into the sweep
    artifact (schema v2). Budget numbers mirror the spend record; byte
    numbers make the paper's communication argument queryable per point
    (with newton/gd_20 reference columns at the same p)."""
    k = n_transmissions(cfg)
    eps_r, delta_r = round_budget(cfg)
    return {
        "n_transmissions": k,
        "bytes_per_round": BYTES_PER_SCALAR * p,
        "bytes_per_machine": qn_bytes_per_machine(p, cfg),
        "eps_per_round": eps_r,
        "delta_per_round": delta_r,
        "newton_bytes_per_machine": newton_bytes_per_machine(p),
        "gd20_bytes_per_machine": gd_bytes_per_machine(p, 20),
    }
