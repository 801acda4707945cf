"""Algorithm 1: robust distributed quasi-Newton estimation with DP (§4) —
``repro/core/protocol.py`` counterpart: the flat path (``protocol_rounds``,
``DPQNProtocol``) and the pytree engine (``protocol_tree_rounds``, one
quasi-Newton training step over a parameter tree).

Machines are a leading axis of the data, ``X (m+1, n, p)`` with machine 0
the central processor; transmissions are explicit tensors, so DP noise and
Byzantine corruption are applied exactly where the paper applies them (on
the wire, ``core/transport.py``), and every center-side reduction goes
through the ``repro_torch.agg`` registry: on a CUDA tensor that is the
hand-written order-statistics kernel.

Round structure (five p-vector transmissions):
  R1  theta_hat_j + b1          -> DCQ -> theta_cq            (4.2)/(4.4)
  R2  grad_j(theta_cq) + b2     -> DCQ -> g_cq                (4.6)
  R3  Hinv_j g_cq + b3          -> DCQ -> H1; theta_os        (4.7)/(4.8)
  R4  grad-diff + b4            -> DCQ -> gdiff_cq, g_os      (4.12)
  R5  V^T Hinv_j V g_os + b5    -> DCQ -> H2; theta_qn        (4.15)
In ``center_trust="untrusted"`` mode (§4.3) the node machines also
transmit DP gradient variances ("R2b var"): six DP transmissions.

Monte-Carlo replicates are an axis written out, not a loop: the data and
the Byzantine mask are shared, so R1's local solve and ``lambda_j`` are
computed once, and the noise and every statistic after it carry a leading
replicate axis ``R``. Each center-side aggregation is then ONE launch over
``(R, m+1, p)``.

Random draws: torch cannot reproduce ``jax.random``. The core takes either
a ``torch.Generator`` (port-native draws) or pre-drawn standard normals per
transmission (``noise``, and ``attack_noise`` for the attacks that draw),
keyed by transmission name; a parity test hands over the reference's own
draws through the latter.

Machine maps (the reference's ``machine_map=``): the per-machine math runs
on the rows a machine map gives this process, ``machine_map.local(X)``,
and each result is gathered back into the full machine axis,
``machine_map.gather(x, dim)``, before the wire. The default,
:class:`AllMachines`, is every machine on this device (both are the
identity); ``dist.sharded_protocol.machine_map(mesh)`` spreads the machine
axis over the ranks of a ``torch.distributed`` mesh, each rank computing
its own machines and the center's work running replicated on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch import privacy, resolve_device
from repro_torch.agg import median_deviation_variance
from repro_torch.attacks import needs_key, resolve
from repro_torch.configs.base import ProtocolConfig, TreeProtocolConfig
from repro_torch.core import dp, local
from repro_torch.core.bfgs import (LBFGSMemory, VOp, lbfgs_gamma, make_v,
                                   push_leaf_, two_loop_)
from repro_torch.core.losses import MEstimationProblem
from repro_torch.core.transport import (_match, active_payload, leaf_sum,
                                        tree_dot, tree_flatten,
                                        tree_leaves, tree_map,
                                        tree_unflatten, wire_aggregate,
                                        wire_corrupt, wire_noise)


class AllMachines:
    """The default machine map: every machine on this device, so
    ``local`` and ``gather`` are the identity (the reference's
    ``vmap_machines``)."""
    world, rank = 1, 0

    def local(self, x: Any) -> Any:
        return x

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return x


ALL_MACHINES = AllMachines()


def monte_carlo_mrse(thetas: torch.Tensor, target: torch.Tensor) -> float:
    """Mean root-square error over the replicate axis of a
    ``run_monte_carlo`` output field: thetas (reps, p), target (p,)."""
    return float(torch.linalg.vector_norm(thetas - target, dim=-1).mean())


# ------------------------------------------------------------ budget layout

#: transmission name -> reported-noise key in ``ProtocolResult.noise_sd``
_SD_KEY = {"R1 theta": "s1", "R2 grad": "s2", "R2b var": "s6",
           "R3 newton-dir": "s3", "R4 grad-diff": "s4", "R5 bfgs-dir": "s5"}


def transmission_names(cfg: ProtocolConfig) -> Tuple[str, ...]:
    """The DP transmissions Algorithm 1 performs under ``cfg``, in order:
    the five p-vector rounds, plus "R2b var" after R2 when the center is
    untrusted."""
    names = ["R1 theta", "R2 grad", "R3 newton-dir", "R4 grad-diff",
             "R5 bfgs-dir"]
    if cfg.n_rounds != len(names):
        raise ValueError(
            f"Algorithm 1 performs exactly {len(names)} vector rounds; "
            f"cfg.n_rounds={cfg.n_rounds} would desynchronise the privacy "
            f"budget split from the actual transmissions")
    if cfg.center_trust == "untrusted":
        names.insert(2, "R2b var")
    return tuple(names)


def n_transmissions(cfg: ProtocolConfig) -> int:
    return len(transmission_names(cfg))


def round_budget(cfg: ProtocolConfig) -> Tuple[float, float]:
    """Per-transmission (eps, delta) so basic composition totals the
    budget over the ACTUAL number of DP transmissions (6 untrusted)."""
    k = n_transmissions(cfg)
    return cfg.eps / k, cfg.delta / k


def accountant_round_budget(cfg: ProtocolConfig) -> Tuple[float, float]:
    """Per-transmission budget certified by ``cfg.accountant``.

    ``"basic"`` routes through :func:`round_budget` unchanged (the exact
    eps/k floats); other registry entries invert their composition on the
    host (``repro_torch.privacy``) — e.g. "rdp" records the LARGER
    standalone per-round eps whose Renyi composition still totals
    (cfg.eps, cfg.delta).
    """
    if cfg.accountant == "basic":
        return round_budget(cfg)
    return privacy.get_accountant(cfg.accountant).per_round(
        cfg.eps, cfg.delta, n_transmissions(cfg))


def calibrate_sigma_base(cfg: ProtocolConfig, p: int, n: int) -> Tuple:
    """Per-transmission BASE noise sds (norm factors = 1), aligned with
    ``transmission_names``, in Python floats (exactly the reference's).

    The basic Thm 4.5 sds are scaled by the accountant's noise-multiplier
    ratio vs basic (``repro_torch.privacy``). "basic" and "subexp" sds
    are NEVER rescaled: the ratio is the literal 1.0 and the multiply is
    skipped.
    """
    k = n_transmissions(cfg)
    eps_r, delta_r = cfg.eps / k, cfg.delta / k
    nl = cfg.noiseless
    s1 = dp.s1_theta(p, n, cfg.gammas[0], eps_r, delta_r, 1.0, cfg.tail)
    s2 = dp.s2_grad(p, n, cfg.gammas[1], eps_r, delta_r, cfg.tail)
    s3 = 0.0 if nl else dp.s3_newton_dir(p, n, cfg.gammas[2], eps_r, delta_r,
                                         1.0, 1.0, cfg.tail)
    s4 = 0.0 if nl else dp.s4_grad_diff(p, n, cfg.gammas[3], eps_r, delta_r,
                                        1.0, cfg.tail)
    s5 = 0.0 if nl else dp.s5_bfgs_dir(p, n, cfg.gammas[4], eps_r, delta_r,
                                       1.0, 1.0, cfg.tail)
    out = [s1, s2, s3, s4, s5]
    if cfg.center_trust == "untrusted":
        out.insert(2, dp.s6_variance(p, n, 1.0, eps_r, delta_r))
    if cfg.accountant != "basic":
        ratio = privacy.multiplier_ratio(cfg.accountant, cfg.eps, cfg.delta,
                                         k)
        if ratio != 1.0:
            out = [s * ratio for s in out]
    return tuple(out)


def _failure_probs(cfg: ProtocolConfig, p: int, n: int) -> Tuple[float, ...]:
    """Per-transmission sensitivity-failure probabilities (Lemmas 4.3/4.4),
    aligned with ``transmission_names``.

    High-probability accountants ("subexp") record the Lemma 4.4 failure
    probability for EVERY mean-mechanism transmission, and the untrusted
    center's variance release (R2b) the sub-Gaussian bound of Lemma 4.3 at
    gamma = 1; other accountants keep the R1/R2 records.
    """
    acct = privacy.get_accountant(cfg.accountant)
    if acct.failure_prob is not None:
        probs = [acct.failure_prob(p, n, g) for g in cfg.gammas]
        if cfg.center_trust == "untrusted":
            probs.insert(2, dp.mean_dp_failure_prob_subgauss(p, n, 1.0, 1.0))
        return tuple(probs)
    f1 = dp.mean_dp_failure_prob_subexp(p, n, cfg.gammas[0], 1.0, 1.0)
    f2 = dp.mean_dp_failure_prob_subexp(p, n, cfg.gammas[1], 1.0, 1.0)
    probs = [f1, f2, 0.0, 0.0, 0.0]
    if cfg.center_trust == "untrusted":
        probs.insert(2, 0.0)
    return tuple(probs)


class ProtocolArrays(NamedTuple):
    """Everything ``protocol_rounds`` produces, as tensors. In a batched
    run every field has a leading replicate axis."""
    theta_cq: torch.Tensor       # initial DCQ estimator (4.4)
    theta_os: torch.Tensor       # one-stage estimator (4.8)
    theta_qn: torch.Tensor       # final quasi-Newton estimator
    sigmas: torch.Tensor         # (n_tx,) reported noise sd per transmission
    ledger_eps: torch.Tensor     # (n_tx,) per-transmission eps spend
    ledger_delta: torch.Tensor   # (n_tx,) per-transmission delta spend
    failure_probs: torch.Tensor  # (n_tx,) sensitivity failure probabilities
    v_s: torch.Tensor            # BFGS curvature pair: s = theta_os - theta_cq
    v_y: torch.Tensor            # y = gdiff_cq
    v_rho: torch.Tensor          # rho = 1 / (s . y)


@dataclasses.dataclass
class ProtocolResult:
    theta_cq: torch.Tensor         # initial DCQ estimator (4.4)
    theta_os: torch.Tensor         # one-stage estimator (4.8)
    theta_qn: torch.Tensor         # final quasi-Newton estimator
    accountant: dp.PrivacyAccountant
    noise_sd: Dict[str, float]
    v_op: Optional[VOp] = None
    arrays: Optional[ProtocolArrays] = None


def _full_fp32() -> None:
    """Float32 products in full precision on the card: the reference runs
    float32 throughout, and TF32 keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rdiv(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as one rounded division (PyTorch's ``float / tensor``
    is a reciprocal and a multiply: two roundings)."""
    return torch.full_like(den, num) / den


def _solve(h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Batched ``h^{-1} g`` for ``h (*B, p, p)``, ``g`` broadcastable to
    ``(*B, p)``."""
    g = g.expand(h.shape[:-1])
    return torch.linalg.solve(h, g.unsqueeze(-1)).squeeze(-1)


# ------------------------------------------------------------ the core

def protocol_rounds(X: torch.Tensor, y: torch.Tensor,
                    problem: MEstimationProblem, cfg: ProtocolConfig,
                    byz_mask: Optional[torch.Tensor] = None,
                    attack: str = "scale", attack_factor=-3.0,
                    theta0: Optional[torch.Tensor] = None,
                    theta_cq_override: Optional[torch.Tensor] = None, *,
                    reps: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[Mapping[str, torch.Tensor]] = None,
                    attack_noise: Optional[Mapping[str, torch.Tensor]] = None,
                    machine_map: AllMachines = ALL_MACHINES
                    ) -> ProtocolArrays:
    """Paper Algorithm 1 on the device of ``X``.

    ``X``: (m+1, n, p), ``y``: (m+1, n); machine 0 is the central
    processor; ``byz_mask`` (m,) marks the Byzantine node machines.

    ``reps=None`` runs one replicate (outputs without a replicate axis);
    ``reps=R`` runs R replicates on the same data at once (every output
    gains a leading ``R``). Draws come from ``noise``/``attack_noise``
    when given — standard normals keyed by transmission name, shaped like
    the transmission, ``(m+1, p)`` (``(m, p)`` for "R2b var") with a
    leading ``R`` in a batched run — and otherwise from ``generator``, in
    the reference's key order: each transmission's noise, then its attack
    draws.

    ``machine_map`` runs the per-machine math (local fits, ``eigvalsh``,
    gradients, Newton and BFGS directions) on its rows of ``X`` and
    gathers every result before it is noised; the draws, the attack and
    every aggregation see the full machine axis. ``X`` is the whole
    ``(m+1, n, p)`` on every rank (machine 0's shard serves the center's
    variances); a rank reads only its rows and machine 0's.
    """
    _full_fp32()
    mm = machine_map
    prob = problem
    m_plus_1, n, p = X.shape
    dev, dt = X.device, X.dtype
    R = 1 if reps is None else reps
    names = transmission_names(cfg)
    eps_r, delta_r = accountant_round_budget(cfg)
    sb = dict(zip(names, calibrate_sigma_base(cfg, p, n)))
    draws_attack = resolve(attack) != "none" and byz_mask is not None \
        and needs_key(attack)
    if not cfg.noiseless and noise is None and generator is None:
        raise ValueError("a noised run needs a generator or pre-drawn noise")
    if draws_attack and attack_noise is None and generator is None:
        raise ValueError(f"attack {attack!r} draws randomness: pass a "
                         f"generator or attack_noise")

    def draw(table, name, rows):
        shape = (R, rows, p)
        if table is None:
            return torch.randn(shape, generator=generator, device=dev,
                               dtype=dt)
        z = torch.as_tensor(table[name], device=dev, dtype=dt)
        z = z.unsqueeze(0) if reps is None else z
        if tuple(z.shape) != shape:
            raise ValueError(f"draws for {name!r} have shape "
                             f"{tuple(z.shape)}, expected {shape}")
        return z

    if byz_mask is None:
        mask = None
    else:
        # the center (machine 0) is honest
        mask = torch.cat([torch.zeros((1,), dtype=torch.bool, device=dev),
                          torch.as_tensor(byz_mask, device=dev).bool()])
    if theta0 is None:
        theta0 = torch.zeros((p,), dtype=dt, device=dev)

    def transmit(name, rnd, values, sigma, rows_mask):
        """Noise, then corrupt, one transmission: ``values`` is
        ``(rows, p)`` (R1, shared by the replicates) or ``(R, rows, p)``;
        the result is ``(R, rows, p)``."""
        rows = values.shape[-2]
        if cfg.noiseless:
            out = values.expand((R, rows, p))
        else:
            out = wire_noise(draw(noise, name, rows), values, sigma)
        key = draw(attack_noise, name, rows) if draws_attack else None
        return wire_corrupt(key, out, rows_mask, attack=attack,
                            factor=attack_factor, round_idx=rnd)

    Xc, yc = X[0], y[0]  # center's own shard
    Xl, yl = mm.local(X), mm.local(y)  # this process's machines
    sig = []             # per-transmission reported noise sd

    # ---- Round 1: local M-estimators -> theta_cq ----------------------
    # Shared by every replicate: the data do not depend on the draws.
    theta_mine = local.newton_solve(prob, theta0, Xl, yl,
                                    steps=cfg.newton_steps)
    theta_local = mm.gather(theta_mine)                      # (m+1, p)
    # lambda_s (Assumption 7.3): fixed, or calibrated by EACH machine from
    # its local Hessian spectrum (local data only => no privacy cost).
    if cfg.lambda_s is None:
        lam_j = mm.gather(torch.linalg.eigvalsh(
            prob.hessian(theta_mine, Xl, yl))[..., 0].clamp_min(1e-3))
    else:
        lam_j = torch.full((m_plus_1,), cfg.lambda_s, dtype=dt, device=dev)
    s1_j = _rdiv(sb["R1 theta"], lam_j)            # per-machine sd
    s1 = wire_aggregate(s1_j, "median")            # reported/summary value
    theta_dp = transmit("R1 theta", 0, theta_local, s1_j, mask)
    sig.append(s1)

    theta_med = wire_aggregate(theta_dp, "median")                 # (R, p)
    if cfg.center_trust == "trusted":
        sig2 = local.sandwich_diag_variance(prob, theta_med, Xc, yc)
    else:
        # untrusted center: median aggregation, no variance needed here
        sig2 = torch.ones((R, p), dtype=dt, device=dev)
    s1_eff = 0.0 if cfg.noiseless else s1_j[0]     # center's estimate
    scale1 = torch.sqrt(sig2 + n * s1_eff ** 2) / math.sqrt(n)
    agg1 = "median" if cfg.center_trust == "untrusted" else cfg.aggregator
    theta_cq = wire_aggregate(theta_dp, agg1, scale=scale1, K=cfg.K,
                              trim_beta=cfg.trim_beta)
    if theta_cq_override is not None:
        # warm start / ablation hook
        theta_cq = torch.as_tensor(theta_cq_override, dtype=dt,
                                   device=dev).expand((R, p))

    # ---- Round 2: gradients at theta_cq -> g_cq -----------------------
    grads = mm.gather(prob.grad(theta_cq.unsqueeze(1), Xl, yl),
                      dim=1)                                  # (R, m+1, p)
    s2 = sb["R2 grad"]
    grads_dp = transmit("R2 grad", 1, grads, s2, mask)
    sig.append(s2)

    s2_eff = 0.0 if cfg.noiseless else s2
    if cfg.center_trust == "trusted":
        gvar = local.grad_coordinate_variance(prob, theta_cq, Xc, yc)
    else:
        # §4.3: node machines transmit DP variances; the center medians
        # them (node rows only: m of m+1).
        s6 = sb["R2b var"]
        node_gvar = mm.gather(prob.grad_variance(
            theta_cq.unsqueeze(1), Xl, yl), dim=1)[:, 1:]
        node_gvar = transmit("R2b var", 1, node_gvar, s6,
                             None if mask is None else mask[1:])
        gvar = wire_aggregate(node_gvar, "median")
        sig.append(s6)
    scale2 = torch.sqrt(gvar.clamp_min(1e-12) + n * s2_eff ** 2) \
        / math.sqrt(n)
    g_cq = _agg_for(cfg, "grad", grads_dp, scale2)

    # ---- Round 3: Newton directions -> theta_os -----------------------
    eye = torch.eye(p, dtype=dt, device=dev)
    h_cq = prob.hessian(theta_cq.unsqueeze(1), Xl, yl) + 1e-9 * eye
    dirs = mm.gather(_solve(h_cq, g_cq.unsqueeze(1)), dim=1)  # (R, m+1, p)
    dir_norm = torch.linalg.vector_norm(dirs, dim=-1)   # per machine (Thm 4.5(3))
    s3 = sb["R3 newton-dir"]
    s3_lam = _rdiv(s3, lam_j)                                 # (m+1,)
    dirs_dp = transmit("R3 newton-dir", 2, dirs, s3_lam * dir_norm, mask)
    sig.append(s3)

    if cfg.center_trust == "trusted":
        hvar = local.newton_dir_variance(prob, theta_cq, Xc, yc, g_cq)
    else:
        hvar = median_deviation_variance(dirs_dp, n, axis=-2)
    s3_0 = s3_lam[0] * dir_norm[:, 0]                          # (R,)
    scale3 = torch.sqrt(hvar.clamp_min(1e-12)
                        + (n * s3_0 ** 2).unsqueeze(-1)) / math.sqrt(n)
    H1 = _agg_for(cfg, "dir", dirs_dp, scale3)
    theta_os = theta_cq - H1

    # ---- Round 4: gradient differences -> gdiff_cq, g_os --------------
    gdiff = mm.gather(prob.grad(theta_os.unsqueeze(1), Xl, yl)
                      - prob.grad(theta_cq.unsqueeze(1), Xl, yl), dim=1)
    step = theta_os - theta_cq                                 # (R, p)
    s4 = sb["R4 grad-diff"]
    s4_eff = s4 * torch.linalg.vector_norm(step, dim=-1)       # (R,)
    gdiff_dp = transmit("R4 grad-diff", 3, gdiff, s4_eff.unsqueeze(-1), mask)
    sig.append(s4)

    if cfg.center_trust == "trusted":
        gd = prob.per_sample_grads(theta_os, Xc, yc) \
            - prob.per_sample_grads(theta_cq, Xc, yc)
        gdvar = gd.var(dim=-2, correction=0)
        gosvar = local.grad_coordinate_variance(prob, theta_os, Xc, yc)
    else:
        gdvar = median_deviation_variance(gdiff_dp, n, axis=-2)
        gosvar = gvar
    s4_term = (n * s4_eff ** 2).unsqueeze(-1)
    scale4 = torch.sqrt(gdvar.clamp_min(1e-12) + s4_term) / math.sqrt(n)
    gdiff_cq = _agg_for(cfg, "gdiff", gdiff_dp, scale4)
    scale4b = torch.sqrt(gosvar.clamp_min(1e-12) + n * s2_eff ** 2
                         + s4_term) / math.sqrt(n)
    g_os = _agg_for(cfg, "g_os", grads_dp + gdiff_dp, scale4b)

    # ---- Round 5: BFGS directions -> theta_qn --------------------------
    v = make_v(s=step, y=gdiff_cq)
    # machine part of (4.15): V^T H_j^{-1} V g_os, H_j at theta_cq (R3's)
    hinv_vg = _solve(h_cq, v(g_os, transpose=False).unsqueeze(1))
    h3 = mm.gather(v.rows()(hinv_vg, transpose=True), dim=1)  # (R, m+1, p)
    s5 = sb["R5 bfgs-dir"]
    h3_norm = torch.linalg.vector_norm(h3, dim=-1)             # (R, m+1)
    h3_dp = transmit("R5 bfgs-dir", 4, h3, s5 * h3_norm, mask)
    sig.append(s5)

    if cfg.center_trust == "trusted":
        h3var = local.bfgs_dir_variance(prob, theta_cq, Xc, yc, v, g_os)
    else:
        h3var = median_deviation_variance(h3_dp, n, axis=-2)
    s5_0 = s5 * h3_norm[:, 0]
    scale5 = torch.sqrt(h3var.clamp_min(1e-12)
                        + (n * s5_0 ** 2).unsqueeze(-1)) / math.sqrt(n)
    h3_agg = _agg_for(cfg, "h3", h3_dp, scale5)
    # center-side rank-1 term: rho (s s^T) g_os  (below eq. 4.15)
    H2 = h3_agg + v.rho.unsqueeze(-1) * step \
        * (step * g_os).sum(dim=-1, keepdim=True)
    theta_qn = theta_os - H2

    k = len(names)
    if len(sig) != k:
        raise RuntimeError("spend ledger out of sync with transmission_names")

    def per_rep(vals):
        return torch.as_tensor(vals, dtype=torch.float32,
                               device=dev).expand((R, k))

    sigmas = torch.stack([torch.as_tensor(s, dtype=torch.float32,
                                          device=dev).expand((R,))
                          for s in sig], dim=-1)
    out = ProtocolArrays(
        theta_cq=theta_cq, theta_os=theta_os, theta_qn=theta_qn,
        sigmas=sigmas, ledger_eps=per_rep([eps_r] * k),
        ledger_delta=per_rep([delta_r] * k),
        failure_probs=per_rep(_failure_probs(cfg, p, n)),
        v_s=v.s, v_y=v.y, v_rho=v.rho)
    if reps is None:
        out = ProtocolArrays(*(f[0] for f in out))
    return out


def _agg_for(cfg: ProtocolConfig, name: str, values, scale):
    """Untrusted-center mode uses the median everywhere except the gradient
    round (paper §4.3 keeps DCQ for 'crucial statistics such as
    gradients')."""
    if cfg.center_trust == "untrusted" and name not in ("grad",):
        return wire_aggregate(values, method="median")
    return wire_aggregate(values, method=cfg.aggregator, scale=scale,
                          K=cfg.K, trim_beta=cfg.trim_beta)


# ---------------------------------------------- pytree (model-scale) engine

#: each tree transmission's round index and its (noise, attack) slots in
#: the 16-way key split the flat path uses (4/5 belong to its untrusted
#: variance round)
_TREE_ROUNDS = {"R1 theta": (0, 0, 1), "R2 grad": (1, 2, 3),
                "R3 newton-dir": (2, 6, 7), "R4 grad-diff": (3, 8, 9),
                "R5 bfgs-dir": (4, 10, 11)}


class ProtocolTreeArrays(NamedTuple):
    """Output of one pytree protocol step. Every tree has ``theta``'s
    structure; ``mem`` is the updated per-machine L-BFGS history the
    trainer threads into the next step."""
    theta_cq: Any            # robustly aggregated params after R1
    theta_os: Any            # one-stage params after R3
    theta_qn: Any            # final quasi-Newton params after R5
    v_s: Any                 # curvature pair: s = theta_os - theta_cq
    v_y: Any                 # y = aggregated grad-diff (R4)
    mem: LBFGSMemory         # per-machine (s, y) history, machine axis first
    losses: torch.Tensor     # (m,) machine-local losses at the incoming theta
    grad_norm: torch.Tensor  # ||g_cq|| over the whole tree, float32


def _split_key(key: torch.Generator) -> list:
    """Sixteen generators seeded from ``key`` on its device: the port's
    analogue of ``jax.random.split(key, 16)``."""
    seeds = torch.randint(0, 2 ** 62, (16,), generator=key,
                          device=key.device).tolist()
    return [torch.Generator(device=key.device).manual_seed(s)
            for s in seeds]


def _stacks(leaves, m: int) -> list:
    """One empty ``(m, *leaf)`` buffer per leaf."""
    return [torch.empty((m,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device) for x in leaves]


def protocol_tree_rounds(key: Optional[torch.Generator], theta: Any,
                         batches: Any, grad_fn: Callable, cfg:
                         TreeProtocolConfig,
                         mem: Optional[LBFGSMemory] = None,
                         byz_mask: Optional[torch.Tensor] = None,
                         attack: str = "none", attack_factor=-3.0,
                         sigmas: Optional[Mapping] = None,
                         n: Optional[int] = None, *,
                         noise: Optional[Mapping] = None,
                         attack_noise: Optional[Mapping] = None,
                         machine_map: AllMachines = ALL_MACHINES
                         ) -> ProtocolTreeArrays:
    """Algorithm 1's five transmissions over a parameter tree: one robust
    DP quasi-Newton training step.

      R1  machine-local SGD steps -> theta_j     -> agg -> theta_cq  (4.4)
      R2  grad_j(theta_cq)                       -> agg -> g_cq      (4.6)
      R3  per-machine L-BFGS dir on g_cq         -> agg -> H1;
          theta_os = theta_cq - lr * H1                              (4.8)
      R4  grad_j(theta_os) - grad_j(theta_cq)    -> agg -> y;
          s = theta_os - theta_cq                                    (4.12)
      R5  push (s, y_j) into machine j's memory (skipped where
          s . y_j <= 1e-10); L-BFGS dir on g_os = g_cq + y
                                                 -> agg -> H2;
          theta_qn = theta_os - lr * H2                              (4.15)

    Every transmission is noised, then corrupted, then aggregated, leaf by
    leaf (``core/transport.py``): on the card one B1 launch per leaf for
    the kernel rules. Each machine pushes its own raw grad-diff.

    ``theta``: a tree of tensors (or one tensor); ``batches``: a tree whose
    leaves carry the machine axis first; ``grad_fn(theta, batch) -> (loss,
    grad tree)`` for one machine's batch. The machines run in a loop that
    writes into one ``(m, *leaf)`` buffer per leaf and round, and each
    buffer is freed leaf by leaf as it is aggregated (R2's gradients are
    recomputed in R4, as the reference does, not kept). Every tree stays in
    its leaves' dtype. ``mem`` (None: an empty one) is updated IN PLACE and
    returned: it is 2 * hist * m parameter copies.

    ``sigmas`` overrides the per-leaf calibration (``{transmission name:
    sigma tree or number}``, ``dp.calibrate_tree_sigmas``), which otherwise
    needs ``n``, the samples per machine; ``cfg.eps <= 0`` runs noiseless.
    Draws: ``noise``/``attack_noise`` ``{transmission name: tree of
    standard normals (m, *leaf)}``, or else from ``key`` (a generator),
    split sixteen ways into the reference's slots, each slot drawing leaf
    by leaf.

    ``machine_map`` (the reference's): this process loops over its own
    machines, ``machine_map.local(batches)``, into ``(m / world, *leaf)``
    buffers, and ``tx`` gathers each leaf into ``(m, *leaf)`` right before
    its noise, corruption and aggregation. ``mem`` then holds this
    process's machines only (2 * hist * m / world parameter copies), R4's
    push writes each machine's own y into it, and the returned ``mem`` is
    that local memory; ``losses`` are gathered, so every field but
    ``mem`` is the same on every rank.

    Under a payload sharding (``dist.payload``, the trainers' "model"
    axis) ``theta``, ``mem`` and every round's buffers hold this rank's
    slice of each sharded leaf; the sigmas are the whole leaves', the
    tree-wide sums (s . y, the two-loop's, the gradient norm) are summed
    over the model group (``transport.leaf_sum``), whole-leaf ``noise``
    tables are cut to the slice, and a sharded leaf draws from its
    generator's fork for this model rank."""
    leaves, treedef = tree_flatten(theta)
    pl = active_payload()
    mm = machine_map
    batches = tree_map(mm.local, batches)
    k = tree_leaves(batches)[0].shape[0]      # this process's machines
    noiseless = cfg.eps <= 0.0
    if sigmas is None and not noiseless:
        if n is None:
            raise ValueError("per-leaf DP calibration needs n (samples per "
                             "machine) when sigmas are not supplied")
        sigmas = dp.calibrate_tree_sigmas(
            theta if pl is None else pl.full_like(theta), n, cfg.eps,
            cfg.delta, cfg.gammas, cfg.tail, accountant=cfg.accountant)
    corrupt = byz_mask is not None and resolve(attack) != "none"
    if key is None and ((not noiseless and noise is None) or (
            corrupt and needs_key(attack) and attack_noise is None)):
        raise ValueError("a noised run, or an attack that draws, needs a "
                         "generator or pre-drawn normals")
    gens = _split_key(key) if key is not None else None
    if mem is None:
        mem = LBFGSMemory.init_like(cfg.hist, theta, machines=k)
    s_hist, y_hist = tree_leaves(mem.s_hist), tree_leaves(mem.y_hist)

    def batch(j):
        return tree_map(lambda x: x[j], batches)

    def grads(t, j):
        loss, g = grad_fn(tree_unflatten(treedef, t), batch(j))
        return loss, tree_leaves(g)

    def tx(name, stack, pre=None, post=None):
        """One transmission of ``stack`` (emptied as it goes): per leaf,
        ``pre(i, raw)``, noise, corrupt, aggregate, ``post(i, agg)``."""
        rnd, k_noise, k_attack = _TREE_ROUNDS[name]
        zs = tree_leaves(noise[name]) if noise is not None else None
        azs = tree_leaves(attack_noise[name]) \
            if attack_noise is not None else None

        def draw(i, table, k):      # leaf i's draws: its row, or a key
            z = gens[k] if table is None else table[i]
            return z if pl is None else pl.leaf_key(i, z)
        sig = None if noiseless else _match(theta, sigmas[name])
        out = []
        for i in range(len(stack)):
            v, stack[i] = stack[i], None
            if pre is not None:
                pre(i, v)
            v = mm.gather(v)
            if not noiseless:
                z = draw(i, zs, k_noise)
                (v,) = wire_noise(z if zs is None else [z], [v], [sig[i]])
            if corrupt:
                k = None
                if needs_key(attack):
                    k = draw(i, azs, k_attack)
                    k = k if azs is None else [k]
                (v,) = wire_corrupt(k, [v], byz_mask, attack=attack,
                                    factor=attack_factor, round_idx=rnd)
            (red,) = wire_aggregate([v], cfg.aggregator, K=cfg.K,
                                    trim_beta=cfg.trim_beta)
            del v
            out.append(red if post is None else post(i, red))
        return out

    def machine_rows(fill):
        """A round's ``(k, *leaf)`` buffers, machine j's row of every leaf
        written by ``fill(j, rows)`` (the loops live in functions, so no
        view of a buffer outlives its round and keeps it alive)."""
        stack = _stacks(leaves, k)
        for j in range(k):
            fill(j, [buf[j] for buf in stack])
        return stack

    def local_fit(j, rows):               # R1: machine j's SGD steps
        for step in range(cfg.local_steps):
            loss, g = grads(rows if step else leaves, j)
            if step == 0:
                losses.append(loss)
                for r, t, gg in zip(rows, leaves, g):
                    torch.mul(gg, -cfg.local_lr, out=r)
                    r.add_(t)
            else:
                for r, gg in zip(rows, g):
                    r.add_(-cfg.local_lr * gg)

    def grad_at(theta):                   # R2: machine j's gradient
        def fill(j, rows):
            for r, gg in zip(rows, grads(theta, j)[1]):
                r.copy_(gg)
        return fill

    def grad_diff(j, rows):               # R4: its gradient difference
        fill = grad_at(theta_os)
        fill(j, rows)
        for r, gg in zip(rows, grads(theta_cq, j)[1]):
            r.sub_(gg)

    def direction(g, y=None):             # R3/R5: its L-BFGS direction
        def fill(j, rows):                # on g, or on g_os = g + y
            for i, r in enumerate(rows):
                if y is None:
                    r.copy_(g[i])
                else:
                    torch.add(g[i], y[i], out=r)
            mm = mem.machine(j)
            two_loop_(mm, rows, lbfgs_gamma(mm))
        return fill

    def curvature(stack):
        """``(k,)``: s . y_j for each machine, s formed leaf by leaf (no
        standing copy), summed over the leaves as ``tree_dot`` sums
        (``leaf_sum``)."""
        parts = []
        for i, buf in enumerate(stack):
            s = theta_os[i] - theta_cq[i]
            parts.append(torch.stack([torch.dot(s.reshape(-1),
                                                buf[j].reshape(-1))
                                      for j in range(k)]))
        return leaf_sum(parts)

    def push(i, raw):
        # machine j keeps its old memory (and count) unless s . y_j > 1e-10:
        # a pair without curvature would break the two-loop
        s = theta_os[i] - theta_cq[i]
        for j in pushed:
            push_leaf_(s_hist[i][j], s)
            push_leaf_(y_hist[i][j], raw[j])

    losses = []
    with torch.no_grad():
        # R1: machine-local steps -> theta_cq
        theta_cq = tx("R1 theta", machine_rows(local_fit))
        # R2: gradients at theta_cq -> g_cq
        g_cq = tx("R2 grad", machine_rows(grad_at(theta_cq)))
        grad_norm = torch.sqrt(tree_dot(g_cq, g_cq)).to(torch.float32)
        # R3: per-machine L-BFGS directions -> theta_os
        theta_os = tx("R3 newton-dir", machine_rows(direction(g_cq)),
                      post=lambda i, h: theta_cq[i] + (-cfg.lr) * h)
        # R4: gradient differences -> y, and the curvature push
        stack = machine_rows(grad_diff)
        ok = curvature(stack) > 1e-10
        pushed = [j for j, o in enumerate(ok.tolist()) if o]
        v_y = tx("R4 grad-diff", stack, pre=push)
        del stack
        mem.count.add_(ok.to(mem.count.dtype))
        # R5: L-BFGS directions on g_os = g_cq + y -> theta_qn
        stack = machine_rows(direction(g_cq, v_y))
        del g_cq
        theta_qn = tx("R5 bfgs-dir", stack,
                      post=lambda i, h: theta_os[i] + (-cfg.lr) * h)
        del stack
        v_s = [a - b for a, b in zip(theta_os, theta_cq)]

    return ProtocolTreeArrays(
        *(tree_unflatten(treedef, t)
          for t in (theta_cq, theta_os, theta_qn, v_s, v_y)),
        mem=mem, losses=mm.gather(torch.stack(losses)),
        grad_norm=grad_norm)


# ------------------------------------------------------- the stateful shell

class DPQNProtocol:
    """Paper Algorithm 1 on one device (``cuda`` unless ``device`` says
    otherwise). ``run`` and ``run_monte_carlo`` take pre-sharded data,
    X: (m+1, n, p), y: (m+1, n), machine 0 the central processor, and move
    it to that device. ``machine_map`` spreads the per-machine math over
    ranks (``dist.sharded_protocol.machine_map``); by default every
    machine runs here."""

    def __init__(self, problem: MEstimationProblem, cfg: ProtocolConfig,
                 device=None, machine_map: AllMachines = ALL_MACHINES):
        self.problem = problem
        self.cfg = cfg
        self.device = resolve_device(device)
        self.machine_map = machine_map

    def _move(self, v):
        """A tensor, array or ``{name: draws}`` table on this device."""
        if v is None:
            return None
        if isinstance(v, Mapping):
            return {k: torch.as_tensor(t, device=self.device)
                    for k, t in v.items()}
        return torch.as_tensor(v, device=self.device)

    def _rounds(self, reps, X, y, byz_mask, attack, attack_factor, theta0,
                theta_cq_override, generator, noise, attack_noise):
        mv = self._move
        return protocol_rounds(
            mv(X), mv(y), self.problem, self.cfg, byz_mask=mv(byz_mask),
            attack=attack, attack_factor=attack_factor, theta0=mv(theta0),
            theta_cq_override=mv(theta_cq_override), reps=reps,
            generator=generator, noise=mv(noise),
            attack_noise=mv(attack_noise), machine_map=self.machine_map)

    def _finalize(self, arrays: ProtocolArrays) -> ProtocolResult:
        """Rebuild the host-side accountant from the spend ledger."""
        names = transmission_names(self.cfg)
        eps_r, delta_r = accountant_round_budget(self.cfg)
        acct = dp.PrivacyAccountant()
        noise_sd: Dict[str, float] = {}
        sigmas = arrays.sigmas.tolist()
        fails = arrays.failure_probs.tolist()
        for i, name in enumerate(names):
            acct.spend(name, eps_r, delta_r, sigmas[i], fails[i])
            noise_sd[_SD_KEY[name]] = sigmas[i]
        v = VOp(s=arrays.v_s, y=arrays.v_y, rho=arrays.v_rho)
        return ProtocolResult(
            theta_cq=arrays.theta_cq, theta_os=arrays.theta_os,
            theta_qn=arrays.theta_qn, accountant=acct, noise_sd=noise_sd,
            v_op=v, arrays=arrays)

    # -- single replicate ---------------------------------------------------
    def run(self, X, y, byz_mask=None, attack: str = "scale",
            attack_factor: float = -3.0, theta0=None,
            theta_cq_override=None, *,
            generator: Optional[torch.Generator] = None,
            noise: Optional[Mapping[str, torch.Tensor]] = None,
            attack_noise: Optional[Mapping[str, torch.Tensor]] = None
            ) -> ProtocolResult:
        arrays = self._rounds(None, X, y, byz_mask, attack, attack_factor,
                              theta0, theta_cq_override, generator, noise,
                              attack_noise)
        return self._finalize(arrays)

    # -- batched Monte-Carlo runs ------------------------------------------
    def run_monte_carlo(self, reps: int, X, y, byz_mask=None,
                        attack: str = "scale", attack_factor: float = -3.0,
                        theta0=None, theta_cq_override=None, *,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Mapping[str, torch.Tensor]] = None,
                        attack_noise: Optional[Mapping[str, torch.Tensor]]
                        = None) -> ProtocolArrays:
        """Run ``reps`` independent replicates of Algorithm 1 at once on
        shared data: every field of the result has a leading replicate
        axis (e.g. ``theta_qn``: (reps, p)); only the draws vary."""
        return self._rounds(reps, X, y, byz_mask, attack, attack_factor,
                            theta0, theta_cq_override, generator, noise,
                            attack_noise)
