"""Gradient-level robust DP aggregation over a leading machine axis —
``repro/dist/grad_agg.py`` counterpart.

The paper's wire model (§4) applied to training: every leaf of a gradient
tree has shape ``(m, ...)``, one slice per node machine. A step is

    corrupt_machines (Byzantine attack on the transmitted message)
      -> add_dp_noise (per-machine Gaussian mechanism)
        -> aggregate_machine_axis (mean / median / trimmed mean / DCQ)

composed by ``robust_aggregate``. With ``method="mean"``, ``dp_sigma=0``
and ``attack="none"`` this reduces to data-parallel gradient averaging.
``method="dcq"`` means the MAD-calibrated ``"dcq_mad"``: the training wire
carries no variance estimates. On the card the order-statistics rules and
the mean launch the CUDA kernel B1 once per leaf (``repro_torch.agg``).

``robust_aggregate`` takes the tree through the wire one leaf at a time,
so only one leaf's corrupted and noised copies are alive at once (at full
width a leaf is up to 620.8 M coordinates per machine); every step is per
leaf in the reference too, so the result is the same.

Randomness: ``key`` is a ``torch.Generator`` (the attacks that draw and
the noise draw from it, leaf by leaf), and parity callers hand the
reference's draws across instead: ``noise=`` (standard normals, a tree
matching the gradients) and ``attack_noise=``.

With a ``mesh`` (a 1-D machine mesh, ``launch.cli.machine_mesh``) every
leaf holds this rank's machine rows, ``(m / world, ...)``: each leaf is
gathered into the full ``(m, ...)`` axis in machine order
(``collectives.gather_machines``) before the attack, so omniscient attacks
read every row as under the reference's collectives, and the noise is
drawn for the whole axis, the same on every rank from generators seeded
alike. The center's work then runs replicated on every rank.

Under a payload sharding (``dist.payload``, a mesh's "model" axis) a
sharded leaf holds this rank's slice: its sigma is the whole leaf's, a
whole-leaf draw handed in is cut to the slice, and a generator's draw
comes from the step's fork for this model rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch import attacks
from repro_torch.core import dp
from repro_torch.core.transport import (_match, active_payload,
                                        leaf_paths, tree_flatten,
                                        tree_leaf_dims, tree_leaves,
                                        tree_leaves_like, tree_unflatten,
                                        wire_aggregate, wire_corrupt,
                                        wire_noise)

__all__ = ["GradAggConfig", "add_dp_noise", "calibrate_leaf_sigmas",
           "spend_record", "corrupt_machines", "aggregate_machine_axis",
           "robust_aggregate", "transmit_tree"]


@dataclasses.dataclass(frozen=True)
class GradAggConfig:
    """Configuration of the attack -> noise -> aggregation pipeline (the
    reference's fields and defaults)."""
    method: str = "dcq"            # mean | median | trimmed | dcq | ...
    dp_sigma: float = 0.0          # per-machine Gaussian mechanism s.d.
    attack: str = "none"           # any repro_torch.attacks name/alias
    attack_factor: float = -3.0
    trim_beta: float = 0.2         # trimmed-mean fraction
    K: int = 10                    # DCQ composite-quantile levels
    strategy: str = "replicated"   # replicated | sharded
    # The reference's name, kept so configs carry across: None = the
    # kernel on a CUDA tensor and the plain reference on a CPU tensor;
    # True pins the kernel's wrapper, False the reference.
    use_pallas: Optional[bool] = None
    # Per-leaf DP calibration (core.dp): with dp_eps > 0 the flat
    # ``dp_sigma`` is ignored and every leaf's Gaussian mechanism is
    # calibrated from its own dimension at budget (dp_eps, dp_delta),
    # given ``dp_n`` samples per machine and tail constant ``dp_gamma``.
    dp_eps: float = 0.0
    dp_delta: float = 0.05
    dp_gamma: float = 2.0
    dp_n: int = 0                  # samples per machine (needed if dp_eps>0)
    dp_tail: str = "subexp"


def add_dp_noise(grads: Any, sigma: Any, key: Any) -> Any:
    """Gaussian mechanism per machine: every leaf row is an independent
    draw. ``sigma`` is a number (the same s.d. on every leaf) or a tree
    matching ``grads`` (``calibrate_leaf_sigmas``). A number ``sigma == 0``
    is an exact no-op: ``grads`` itself comes back. ``key``: a generator
    or a tree of standard normals matching ``grads``."""
    if isinstance(sigma, (int, float)) and sigma == 0.0:
        return grads
    return wire_noise(key, grads, sigma)


def calibrate_leaf_sigmas(grads: Any, cfg: GradAggConfig) -> Any:
    """Per-leaf Gaussian-mechanism s.d. from each leaf's own dimension:
    the Lemma 4.4 mean mechanism (``core.dp.tree_mean_sigma``) at d_leaf,
    budget (dp_eps, dp_delta). Leaves carry the machine axis first.
    Returns a tree of Python floats."""
    if cfg.dp_n <= 0:
        raise ValueError("per-leaf DP calibration needs dp_n (samples per "
                         f"machine) > 0, got {cfg.dp_n}")
    dims = tree_leaf_dims(grads, machine_axis=True)
    return dp.tree_mean_sigma(dims, cfg.dp_n, cfg.dp_gamma, cfg.dp_eps,
                              cfg.dp_delta, cfg.dp_tail)


def spend_record(tree: Any, cfg: GradAggConfig, accountant=None,
                 name: str = "grad step",
                 machine_axis: bool = False) -> list:
    """The ledger entry pairing one :func:`robust_aggregate` transmission
    with the budget its noise spends: one record per leaf, ``{transmission,
    leaf, dim, sigma, eps, delta}``. With ``dp_eps > 0`` the sigmas are the
    per-leaf calibration ``robust_aggregate`` applies, and an optional
    ``accountant`` gets one ``spend_tree`` entry; flat ``dp_sigma`` noise is
    recorded with ``eps=None`` (no DP claim). No noise, no records."""
    dims_tree = tree_leaf_dims(tree, machine_axis=machine_axis)
    paths = leaf_paths(tree)
    dims = [int(d) for d in tree_leaves(dims_tree)]
    if cfg.dp_eps > 0:
        sigma_tree = dp.tree_mean_sigma(dims_tree, cfg.dp_n, cfg.dp_gamma,
                                        cfg.dp_eps, cfg.dp_delta,
                                        cfg.dp_tail)
        sigmas = [float(s) for s in tree_leaves(sigma_tree)]
        eps, delta = cfg.dp_eps, cfg.dp_delta
        if accountant is not None:
            accountant.spend_tree(name, eps, delta, sigma_tree)
    elif cfg.dp_sigma:
        sigmas = [float(cfg.dp_sigma)] * len(dims)
        eps = delta = None
    else:
        return []
    return [{"transmission": name, "leaf": p, "dim": d, "sigma": s,
             "eps": eps, "delta": delta}
            for p, d, s in zip(paths, dims, sigmas)]


def corrupt_machines(grads: Any, byz_mask: Optional[torch.Tensor],
                     cfg: GradAggConfig, key: Any = None,
                     round_idx: Optional[int] = None) -> Any:
    """The configured Byzantine attack on the machine rows selected by
    ``byz_mask`` (m,) of every leaf, through the ``repro_torch.attacks``
    registry. ``byz_mask=None`` or ``attack="none"`` return ``grads``
    itself. The training path transmits one message per step, so
    round-aware attacks apply at terminal strength (round
    ``N_PROTOCOL_ROUNDS - 1``) unless ``round_idx`` says otherwise.
    ``key``: a generator or a tree of standard normals matching
    ``grads``, for the attacks that draw."""
    attack = attacks.resolve(cfg.attack)
    if byz_mask is None or attack == "none":
        return grads
    if round_idx is None:
        round_idx = attacks.N_PROTOCOL_ROUNDS - 1
    return wire_corrupt(key, grads, byz_mask, attack=attack,
                        factor=cfg.attack_factor, round_idx=round_idx)


def _backend(cfg: GradAggConfig) -> Optional[str]:
    if cfg.use_pallas is None:
        return None
    return "kernel" if cfg.use_pallas else "reference"


def aggregate_machine_axis(values: torch.Tensor,
                           cfg: GradAggConfig) -> torch.Tensor:
    """Aggregate one tensor over its leading machine axis, ``(m, ...) ->
    (...)``, in its own dtype: one B1 launch on the card for the kernel
    rules. ``method="dcq"`` means ``"dcq_mad"``."""
    if values.dim() < 1 or values.shape[0] < 1:
        raise ValueError(f"need a leading machine axis, got "
                         f"{tuple(values.shape)}")
    method = "dcq_mad" if cfg.method == "dcq" else cfg.method
    try:
        # a one-leaf tree: the wire reshapes it to (m, d_leaf) and back
        (out,) = wire_aggregate([values], method, K=cfg.K,
                                trim_beta=cfg.trim_beta,
                                backend=_backend(cfg))
    except KeyError:
        raise ValueError(f"unknown aggregation method {cfg.method!r}") \
            from None
    return out.to(values.dtype)


def robust_aggregate(grads: Any, cfg: GradAggConfig, key: Any = None,
                     byz_mask: Optional[torch.Tensor] = None, *,
                     mesh=None, machine_specs=None,
                     round_idx: Optional[int] = None, noise: Any = None,
                     attack_noise: Any = None) -> Any:
    """Attack -> DP noise -> robust aggregation over a gradient tree whose
    leaves carry the machine axis first; returns the tree without it.

    With ``cfg.dp_eps > 0`` the noise s.d. is calibrated per leaf
    (``calibrate_leaf_sigmas``), otherwise the flat ``cfg.dp_sigma``
    applies. ``key`` is a generator; ``noise``/``attack_noise`` (trees of
    standard normals matching the gathered gradients) replace its draws.

    With a ``mesh`` the leaves hold this rank's machine rows and each is
    gathered before the attack (the reference gathers inside
    ``collectives.sharded_aggregate_leaf`` under ``strategy="sharded"``
    and leaves it to GSPMD otherwise; the port has one way for both).
    ``machine_specs`` (``collectives.tree_machine_specs``), under
    ``strategy="sharded"``, holds every leaf to the sharded contract:
    a rule that is not coordinate-wise needs replicated payload dims."""
    from repro_torch.dist import collectives
    leaves, treedef = tree_flatten(grads)
    if machine_specs is not None and cfg.strategy == "sharded":
        for spec in tree_leaves_like(machine_specs, grads):
            collectives.check_spec(cfg, spec)
    pl = active_payload()
    whole = grads if pl is None else pl.full_like(grads)
    sigma = (calibrate_leaf_sigmas(whole, cfg) if cfg.dp_eps > 0
             else cfg.dp_sigma)
    sigmas = _match(grads, sigma)
    zs = tree_leaves(noise) if noise is not None else [key] * len(leaves)
    azs = tree_leaves(attack_noise) if attack_noise is not None \
        else [key] * len(leaves)
    if pl is not None:
        zs = [pl.leaf_key(i, z) for i, z in enumerate(zs)]
        azs = [pl.leaf_key(i, z) for i, z in enumerate(azs)]
    out = []
    for leaf, sig, z, az in zip(leaves, sigmas, zs, azs):
        if mesh is not None:
            leaf = collectives.gather_machines(leaf, mesh)
        g = corrupt_machines([leaf], byz_mask, cfg, [az] if
                             isinstance(az, torch.Tensor) else az, round_idx)
        g = add_dp_noise(g, sig, [z] if isinstance(z, torch.Tensor) else z)
        out.append(aggregate_machine_axis(g[0], cfg))
        del g
    return tree_unflatten(treedef, out)


def transmit_tree(values: Any, cfg: GradAggConfig, key: Any = None,
                  byz_mask: Optional[torch.Tensor] = None, *,
                  round_idx: int = 0, mesh=None, machine_specs=None,
                  noise: Any = None, attack_noise: Any = None) -> Any:
    """One wire transmission of the five-round tree protocol: corrupt ->
    per-leaf DP noise -> per-leaf robust aggregation, with the actual
    transmission index forwarded to round-aware attacks (a named wrapper
    over :func:`robust_aggregate`)."""
    return robust_aggregate(values, cfg, key, byz_mask, mesh=mesh,
                            machine_specs=machine_specs,
                            round_idx=round_idx, noise=noise,
                            attack_noise=attack_noise)
