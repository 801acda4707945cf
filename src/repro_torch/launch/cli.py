"""Shared CLI flags for the launchers — ``repro/launch/cli.py``
counterpart, plus ``--device`` — and the machine mesh ``--sharded`` runs
on.

One definition of the flags every launcher shares, so the launchers never
drift apart on them.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
from typing import Iterator, Optional

import torch

from repro_torch import privacy


def add_common_flags(ap: argparse.ArgumentParser,
                     arch_default: str = "xlstm-125m"
                     ) -> argparse.ArgumentParser:
    """Model selection, root seed, placement and accountant flags."""
    ap.add_argument("--config", "--arch", dest="arch", default=arch_default,
                    help="model-zoo config name: one of the reference's ten "
                    "(repro_torch.configs.ARCHS)")
    ap.add_argument("--seed", type=int, default=0,
                    help="root seed; per-purpose generators are seeded "
                    "from independent streams (repro_torch.core.keys)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the machine axis over the ranks of a "
                    "torch.distributed world, one device each (torchrun; "
                    "a single process is a world of 1)")
    ap.add_argument("--accountant", default="basic",
                    choices=privacy.registered(),
                    help="repro_torch.privacy accountant (default: basic, "
                    "the paper's even split)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap


def machine_mesh(n_machines: Optional[int], device) -> "DeviceMesh":
    """A 1-D ``DeviceMesh`` named ``machines`` over every rank of the
    process group, the group started here if it is not yet: under
    ``torchrun`` from its environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), otherwise a world of
    1 in this process. NCCL on ``cuda``, each rank on card ``LOCAL_RANK``
    (made the current device); gloo on the CPU.

    Exits with the reference's message when ``n_machines`` (None: no
    check) does not divide over the ranks, and with code 2 when a
    ``cuda`` world asks for more ranks than there are cards (NCCL does not
    put two ranks on one device)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dev = torch.device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if world > cards:
            print(f"error: {world} ranks on {cards} CUDA device(s): NCCL "
                  f"needs a card per rank", file=sys.stderr)
            raise SystemExit(2)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ:
            dist.init_process_group(backend, init_method="env://")
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    n_dev = dist.get_world_size()
    if n_machines is not None and n_machines % n_dev:
        raise SystemExit(f"--machines {n_machines} does not divide over "
                         f"{n_dev} devices")
    return init_device_mesh(dev.type, (n_dev,), mesh_dim_names=("machines",))


def rank0() -> bool:
    """Whether this process is rank 0 of the process group (or runs
    alone): the rank that prints and writes."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


@contextlib.contextmanager
def sharded_run(n_machines: Optional[int], device, sharded: bool
                ) -> Iterator[Optional["DeviceMesh"]]:
    """``--sharded``'s scope: the machine mesh (None when not sharded),
    and the process group destroyed at the end if this scope started
    it."""
    if not sharded:
        yield None
        return
    import torch.distributed as dist
    started = not dist.is_initialized()
    mesh = machine_mesh(n_machines, device)
    try:
        yield mesh
    finally:
        if started:
            dist.destroy_process_group()
