"""Carrying the reference's state across to the port.

The protocol has no weights: its state is the configuration, the data,
the Byzantine mask and the random draws. The model zoo's state is its
configuration, its parameters and its KV cache. The serving path's is
its theta tree, the fleet's updates and the per-round noise draws. Every function takes plain
Python and numpy values (what ``dataclasses.asdict`` and ``numpy.asarray``
give on the JAX side), so the port never imports the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import (ModelConfig, MoEConfig,
                                      ProtocolConfig, SSMConfig)


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


def _stacked(per_rep: Optional[Sequence[Mapping]], dev) -> Optional[dict]:
    if per_rep is None:
        return None
    return {name: torch.as_tensor(np.stack([np.asarray(t[name], np.float32)
                                            for t in per_rep]), device=dev)
            for name in per_rep[0]}


def scenario_inputs_from_numpy(X, y, aux: Mapping,
                               noise: Optional[Sequence[Mapping]] = None,
                               attack_noise: Optional[Sequence[Mapping]]
                               = None, device=None) -> Tuple:
    """One scenario's inputs for ``SweepExecutor(inputs=...)`` from the
    reference's numpy arrays: ``(X, y, aux, noise, attack_noise)``, with
    ``X`` (m+1, n, p) and ``y`` (m+1, n) float32, ``aux`` (the metric's
    target, or the held-out digits split) as float32 tensors, and the
    draws given per replicate — a list of ``{transmission name: (rows,
    p)}`` tables, one per replicate — stacked over a leading replicate
    axis (None leaves the executor's own draws)."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.array(X, np.float32), device=dev),
            torch.as_tensor(np.array(y, np.float32), device=dev),
            {k: torch.as_tensor(np.array(v, np.float32), device=dev)
             for k, v in aux.items()},
            _stacked(noise, dev), _stacked(attack_noise, dev))


# ---------------------------------------------------------------- models

def model_config_from_reference(fields: Mapping) -> ModelConfig:
    """The port's ``ModelConfig`` from ``dataclasses.asdict`` of the
    reference's. Raises on a field the port does not know."""
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields unknown to the port's ModelConfig: "
                         f"{unknown}")
    kw = dict(fields)
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if kw.get("ssm") is not None:
        kw["ssm"] = SSMConfig(**kw["ssm"])
    kw["slstm_at"] = tuple(kw.get("slstm_at", ()))
    return ModelConfig(**kw)


def _flatten(tree: Mapping, n_layers: int, prefix: str = "") -> Dict:
    """The reference's parameter pytree as ``{state_dict key: array}``.
    The layer stack ``layers`` carries a leading L axis; its slice i is
    ``layers.{i}.<path>``."""
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            if name == "layers":
                for path, arr in _flatten(val, n_layers).items():
                    arr = np.asarray(arr)
                    if arr.ndim == 0 or arr.shape[0] != n_layers:
                        raise ValueError(
                            f"layers.{path}: shape {arr.shape} has no "
                            f"leading axis of {n_layers} layers")
                    out.update({f"layers.{i}.{path}": arr[i]
                                for i in range(n_layers)})
            else:
                out.update(_flatten(val, n_layers, f"{name}."))
        else:
            out[name] = val
    return out


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    # a copy (the reference's buffers are read-only and the port writes its
    # cache in place), through f32: numpy has no bfloat16, and bf16 values
    # are exact in f32
    return torch.from_numpy(np.array(arr, np.float32)).to(device=device,
                                                          dtype=dtype)


def params_from_reference(tree: Mapping, cfg: ModelConfig, device=None):
    """The port's ``Model`` holding the reference's parameters: ``tree`` is
    what the reference's ``Model(cfg).init`` returns, as nested dicts of
    numpy arrays with the layer stack on a leading L axis. Raises
    ``ValueError`` on a missing key, an extra key or a wrong shape."""
    from repro_torch.models.model import Model, torch_dtype
    dev = resolve_device(device)
    model = Model(cfg, device="meta")
    want = {name: tuple(p.shape) for name, p in model.named_parameters()}
    got = _flatten(tree, cfg.n_layers)
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameters missing from the reference's tree: "
                         f"{missing}; not in the port's model: {extra}")
    for name, shape in want.items():
        if tuple(np.shape(got[name])) != shape:
            raise ValueError(f"{name}: shape {tuple(np.shape(got[name]))}, "
                             f"the port's model has {shape}")
    dt = torch_dtype(cfg)
    model.load_state_dict({name: _tensor(got[name], dt, dev)
                           for name in want}, strict=True, assign=True)
    return model


def cache_from_reference(tree: Mapping, device=None) -> Dict:
    """The port's decode cache from the reference's (``Model.init_cache``
    or a ``decode_step`` result): ``pos`` as a Python int, ``attn`` k and v
    (L, B, Smax, Hkv, dh) in the reference's dtype (float32 or
    bfloat16)."""
    dev = resolve_device(device)
    attn = {}
    for key in ("k", "v"):
        arr = np.asarray(tree["attn"][key])
        dt = torch.bfloat16 if arr.dtype.name == "bfloat16" \
            else torch.float32
        attn[key] = _tensor(arr, dt, dev)
    return {"pos": int(np.asarray(tree["pos"])), "attn": attn}


# ---------------------------------------------------------------- serving

def _leaf_tensor(arr, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return _tensor(arr, torch.bfloat16, device)
    return torch.from_numpy(np.array(arr)).to(device)


def tree_from_numpy(tree, device=None):
    """A nested ``dict``/``list``/``tuple`` of numpy arrays as the same
    tree of tensors on ``device``, each in its own dtype (a copy; bfloat16
    goes through float32, which holds it exactly)."""
    from repro_torch.core.transport import tree_map
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf_tensor(a, dev), tree)


def serve_noise_from_numpy(draws: Sequence, like, device=None):
    """The reference service's per-round noise draws, one standard-normal
    array ``(C, *leaf)`` per leaf in the reference's leaf order, as the
    ``noise=`` argument of ``AggregationService.flush``: a tree matching
    ``like`` (the served theta, whose leaf order is the reference's)."""
    from repro_torch.core.transport import tree_flatten, tree_unflatten
    dev = resolve_device(device)
    leaves, treedef = tree_flatten(like)
    if len(draws) != len(leaves):
        raise ValueError(f"{len(draws)} draws for {len(leaves)} leaves")
    out = []
    for z, leaf in zip(draws, leaves):
        z = _leaf_tensor(z, dev)
        if tuple(z.shape[1:]) != tuple(leaf.shape):
            raise ValueError(f"draw of shape {tuple(z.shape)} for a leaf "
                             f"of shape {tuple(leaf.shape)}")
        out.append(z)
    return tree_unflatten(treedef, out)
