"""Algorithm 1 with the machine axis spread over ``torch.distributed``
ranks — ``repro/dist/sharded_protocol.py`` counterpart.

The reference runs one program over a ``("machines",)`` mesh: its machine
map is a ``shard_map`` that gives each device its machines' rows, and the
transmissions are gathered before the center's math. Here every rank is a
process running the same program, one rank per device:

  * each rank computes its own machines' statistics (local fits, local
    Hessian spectra, gradients, Newton and BFGS directions, or in the
    tree engine its own machines' gradients and L-BFGS directions);
  * every transmission is gathered in machine order
    (``collectives.gather_machines``) before it is noised, corrupted and
    aggregated, so the draws, the attacks (the omniscient ones read every
    honest row) and the aggregation see the whole axis;
  * the center's math runs replicated: every rank computes the same
    aggregates, with the same draws where the ranks' generators are
    seeded alike or the same tables are handed to each.

The per-machine and the center's math are the single-device code itself
(``core/protocol.py``), so the sharded run equals the unsharded one to
float32 round-off. ``jit=`` has no counterpart.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ProtocolConfig, TreeProtocolConfig
from repro_torch.core.bfgs import LBFGSMemory
from repro_torch.core.losses import MEstimationProblem
from repro_torch.core.protocol import (AllMachines, DPQNProtocol,
                                       ProtocolResult, ProtocolTreeArrays,
                                       protocol_tree_rounds)
from repro_torch.dist.collectives import gather_machines, mesh_axis

__all__ = ["MachineMap", "machine_map", "run_sharded", "run_sharded_tree"]


class MachineMap(AllMachines):
    """The machine map of a mesh's machine axis (the 1-D mesh's one dim,
    or "data" x "pod" of a (data, model) mesh): rank r of ``world`` on it
    holds machines ``[r * k, (r + 1) * k)`` of an axis of ``world * k``.
    On a mapping mesh (the dry run's) this process is rank 0."""

    def __init__(self, mesh: Any):
        self.mesh = mesh
        ax = mesh_axis(mesh, "machines")
        self.world, self.rank, self.axis = ax.size, ax.rank, ax.name

    def local(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % self.world:
            raise ValueError(f"{n} machines do not shard evenly over "
                             f"{self.world} devices on axis {self.axis!r}")
        k = n // self.world
        return x[self.rank * k:(self.rank + 1) * k]

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return gather_machines(x, self.mesh, dim)


def machine_map(mesh: Any) -> MachineMap:
    """The machine map over ``mesh``'s machine axis, for
    ``protocol_rounds``, ``DPQNProtocol`` and ``protocol_tree_rounds``."""
    return MachineMap(mesh)


def run_sharded(prob: MEstimationProblem, cfg: ProtocolConfig, mesh: Any,
                X, y, byz_mask=None, attack: str = "scale",
                attack_factor: float = -3.0, theta0=None, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[Mapping[str, torch.Tensor]] = None,
                attack_noise: Optional[Mapping[str, torch.Tensor]] = None,
                device=None) -> Dict[str, object]:
    """Algorithm 1 with the machines spread over ``mesh``, called on every
    rank alike. ``X`` (m+1, n, p) and ``y`` (m+1, n), machine 0 the
    central processor, as ``DPQNProtocol.run`` takes them; m+1 must divide
    over the ranks. ``generator`` (seeded alike on every rank) or the
    ``noise``/``attack_noise`` tables give the draws. ``device`` defaults
    to the mesh's device type. Returns the three estimators and the full
    ``ProtocolResult``."""
    dev = resolve_device(mesh.device_type if device is None else device)
    proto = DPQNProtocol(prob, cfg, device=dev,
                         machine_map=machine_map(mesh))
    res: ProtocolResult = proto.run(
        X, y, byz_mask=byz_mask, attack=attack, attack_factor=attack_factor,
        theta0=theta0, generator=generator, noise=noise,
        attack_noise=attack_noise)
    return {"theta_cq": res.theta_cq, "theta_os": res.theta_os,
            "theta_qn": res.theta_qn, "result": res}


def run_sharded_tree(key: Optional[torch.Generator], theta: Any,
                     batches: Any, grad_fn: Callable,
                     cfg: TreeProtocolConfig, mesh: Any,
                     mem: Optional[LBFGSMemory] = None, byz_mask=None,
                     attack: str = "none", attack_factor: float = -3.0,
                     n: Optional[int] = None, *,
                     sigmas: Optional[Mapping] = None,
                     noise: Optional[Mapping] = None,
                     attack_noise: Optional[Mapping] = None
                     ) -> ProtocolTreeArrays:
    """The tree engine with its machines spread over ``mesh``: each rank
    runs its machines of ``batches`` (a tree whose leaves carry all m
    machines first; m must divide over the ranks) and keeps their L-BFGS
    memory, ``mem`` of ``m / world`` machines (None: an empty one). The
    other arguments are ``protocol_tree_rounds``'s."""
    return protocol_tree_rounds(
        key, theta, batches, grad_fn, cfg, mem=mem, byz_mask=byz_mask,
        attack=attack, attack_factor=attack_factor, sigmas=sigmas, n=n,
        noise=noise, attack_noise=attack_noise,
        machine_map=machine_map(mesh))
