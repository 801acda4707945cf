"""The machine the dry run models, and the meshes the port runs on —
``repro/launch/mesh.py`` counterpart for the H100.

Target hardware: 256 H100 SXM5 (80 GB) cards, 32 nodes of eight. The
reference's (16, 16) = (data, model) TPU v5e pod becomes (data 32,
model 8): the model axis stays inside one node's NVLink domain of eight
cards, and "data" is the node axis, across InfiniBand. The multi-pod
layout stacks a leading "pod" axis, (pod 2, data 32, model 8).

The production mesh is an axis-size mapping, not a process group: the
dry run traces one rank's step on the meta device, and
``models.sharding`` and ``dist.collectives`` read a mapping as a mesh.

The constants are the H100 SXM5 datasheet's, not measurements. They
replace the reference's single ``ICI_BW`` with two link rates because the
card has two networks of very different speed: NVLink inside a node,
which carries the collectives over "model", and one 400 Gb/s NDR
InfiniBand port per card between nodes, which carries those over "data"
and "pod". A TPU pod's ICI links every chip alike; here a collective's
axis decides its rate, so ``launch.roofline`` prices each collective by
the axis it crosses.
"""
from __future__ import annotations

from typing import Dict

__all__ = ["make_production_mesh", "make_host_mesh", "make_machine_mesh",
           "PEAK_FLOPS_BF16", "HBM_BW", "NVLINK_BW", "IB_BW"]

#: dense bf16 tensor-core peak, FLOP/s per card (H100 SXM5 datasheet)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth, bytes/s per card (H100 SXM5 datasheet)
HBM_BW = 3.35e12
#: NVLink 4, bytes/s per direction per card (900 GB/s bidirectional)
NVLINK_BW = 450e9
#: one 400 Gb/s NDR InfiniBand port per card, bytes/s per direction
IB_BW = 50e9

#: cards per node: the NVLink domain the model axis lives in
NODE_CARDS = 8


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """``{axis name: size}`` of the modelled machine: (data 32, model 8),
    or (pod 2, data 32, model 8)."""
    if multi_pod:
        return {"pod": 2, "data": 32, "model": NODE_CARDS}
    return {"data": 32, "model": NODE_CARDS}


def make_host_mesh(model: int = 1, device="cuda"):
    """A 2-D ``DeviceMesh`` ("data", "model") over every rank of the
    process group, data-major (the group started as
    ``launch.cli.machine_mesh`` starts it where it is not yet: under
    ``torchrun`` from its environment, else a world of 1 in this
    process). ``model`` must divide the world."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.cli import machine_mesh
    if not dist.is_initialized():
        machine_mesh(None, device)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model axis {model} does not divide the world "
                         f"of {n} ranks")
    import torch
    return init_device_mesh(torch.device(device).type, (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_machine_mesh(m: int, device="cuda"):
    """The 1-D mesh the sharded protocol runs on, named ``machines``
    (``launch.cli.machine_mesh``); ``m`` must divide over the ranks."""
    from repro_torch.launch.cli import machine_mesh
    return machine_mesh(m, device)
