"""Carrying the reference's state across to the port.

The protocol has no weights: its state is the configuration, the data,
the Byzantine mask and the random draws. Both functions take plain Python
and numpy values (what ``dataclasses.asdict`` and ``numpy.asarray`` give
on the JAX side), so the port never imports the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ProtocolConfig


def config_from_reference(fields: Mapping) -> ProtocolConfig:
    """The port's ``ProtocolConfig`` from ``dataclasses.asdict`` of the
    reference's. Raises on a field the port does not know."""
    known = {f.name for f in dataclasses.fields(ProtocolConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields unknown to the port's ProtocolConfig: "
                         f"{unknown}")
    kw = dict(fields)
    if "gammas" in kw:
        kw["gammas"] = tuple(float(g) for g in kw["gammas"])
    return ProtocolConfig(**kw)


def _draws(table: Optional[Mapping], dev) -> Optional[dict]:
    if table is None:
        return None
    return {name: torch.as_tensor(np.asarray(z, np.float32), device=dev)
            for name, z in table.items()}


def inputs_from_numpy(X, y, byz_mask=None, noise: Optional[Mapping] = None,
                      attack_noise: Optional[Mapping] = None,
                      device=None) -> dict:
    """The reference's numpy arrays as the port's tensors, keyed like the
    keyword arguments of ``DPQNProtocol.run``/``protocol_rounds``:
    ``X`` (m+1, n, p) and ``y`` (m+1, n) as float32, ``byz_mask`` (m,) as
    bool, and ``noise``/``attack_noise`` (per-transmission standard
    normals keyed by transmission name) as float32."""
    dev = resolve_device(device)
    return {
        "X": torch.as_tensor(np.asarray(X, np.float32), device=dev),
        "y": torch.as_tensor(np.asarray(y, np.float32), device=dev),
        "byz_mask": None if byz_mask is None else
        torch.as_tensor(np.asarray(byz_mask, bool), device=dev),
        "noise": _draws(noise, dev),
        "attack_noise": _draws(attack_noise, dev),
    }
