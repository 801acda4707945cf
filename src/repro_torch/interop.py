"""Carrying the reference's state across to the port.

The protocol has no weights: its state is the configuration, the data,
the Byzantine mask and the random draws; the pytree engine adds its
per-machine L-BFGS memory. The model zoo's state is its
configuration, its parameters and its KV cache. The serving path's is
its theta tree, the fleet's updates and the per-round noise draws. The
trainer's is the parameter tree, the optimizer state, the token batches
and the wire's noise draws (``tree_from_numpy`` of the reference's
standard normals). Every function takes plain
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
                                      ProtocolConfig, SSMConfig,
                                      TreeProtocolConfig)


def _protocol_config(cls, fields: Mapping):
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"fields unknown to the port's {cls.__name__}: "
                         f"{unknown}")
    kw = dict(fields)
    if "gammas" in kw:
        kw["gammas"] = tuple(float(g) for g in kw["gammas"])
    return cls(**kw)


def config_from_reference(fields: Mapping) -> ProtocolConfig:
    """The port's ``ProtocolConfig`` from ``dataclasses.asdict`` of the
    reference's. Raises on a field the port does not know."""
    return _protocol_config(ProtocolConfig, fields)


def tree_config_from_reference(fields: Mapping) -> TreeProtocolConfig:
    """The port's ``TreeProtocolConfig`` from ``dataclasses.asdict`` of
    the reference's. Raises on a field the port does not know."""
    return _protocol_config(TreeProtocolConfig, fields)


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


def _tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    # a copy (the reference's buffers are read-only and the port writes its
    # cache in place), through f32: numpy has no bfloat16, and bf16 values
    # are exact in f32
    return torch.from_numpy(np.array(arr, np.float32)).to(device=device,
                                                          dtype=dtype)


def params_from_reference(tree: Mapping, cfg: ModelConfig, device=None):
    """The port's ``Model`` holding the reference's parameters: ``tree`` is
    what the reference's ``Model(cfg).init`` returns, as nested dicts (and,
    for the ssm family, a list of layers) of numpy arrays, the stacked
    layers on a leading L axis (the port's layout too). Each leaf keeps the
    model's dtype for it: the model's dtype, or f32 for the leaves the
    reference keeps in f32. Raises ``ValueError`` on a missing leaf, an
    extra leaf, a stacked leaf without its L axis or a wrong shape."""
    from repro_torch.core.transport import leaf_paths, tree_leaves
    from repro_torch.models.model import Model
    dev = resolve_device(device)
    model = Model(cfg, device="meta")
    mine = model.params()
    want = dict(zip(leaf_paths(mine), tree_leaves(mine)))
    got = dict(zip(leaf_paths(tree), tree_leaves(tree)))
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameters missing from the reference's tree: "
                         f"{missing}; not in the port's model: {extra}")
    for path, p in want.items():
        have = tuple(np.shape(got[path]))
        if path.startswith("layers/") and have[:1] != (cfg.n_layers,):
            raise ValueError(f"{path}: shape {have} has no leading axis of "
                             f"{cfg.n_layers} layers")
        if have != tuple(p.shape):
            raise ValueError(f"{path}: shape {have}, the port's model has "
                             f"{tuple(p.shape)}")
    # a leaf's path is its state_dict name with "/" for "."
    model.load_state_dict({path.replace("/", "."):
                           _tensor(got[path], p.dtype, dev)
                           for path, p in want.items()}, strict=True,
                          assign=True)
    return model


def cache_from_reference(tree: Mapping, device=None) -> Dict:
    """The port's decode cache from the reference's (``Model.init_cache``
    or a ``decode_step`` result): ``pos`` as a Python int; ``attn`` k and v
    (L or insertions, B, Smax, Hkv, dh), ``ssm`` state and conv (L, ...)
    and the list ``xlstm`` of per-layer caches, each in the reference's
    dtype (float32 or bfloat16)."""
    from repro_torch.core.transport import tree_map
    dev = resolve_device(device)
    out: Dict = {"pos": int(np.asarray(tree["pos"]))}
    for key in ("attn", "ssm", "xlstm"):
        if key in tree:
            out[key] = tree_map(lambda a: _leaf_tensor(a, dev), tree[key])
    return out


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


# ---------------------------------------------------------------- training

def tree_to_numpy(tree) -> dict:
    """A tree of tensors as the same tree of numpy arrays (a copy on the
    host); bfloat16 leaves as float32, which holds them exactly."""
    from repro_torch.core.transport import tree_map

    def leaf(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map(leaf, tree)


def batch_from_numpy(batch: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The reference's LM batch (``data.lm.make_batch``: int32 ``tokens``
    and ``labels``, (B, S, nc) tokens for audio, the vlm's float32
    ``patch_embeds``, plus an optional ``mask``) as the port's: int64 ids,
    a float32 mask, and every other float array in its own float dtype."""
    dev = resolve_device(device)
    out = {}
    for key, val in batch.items():
        arr = np.asarray(val)
        if key == "mask":
            out[key] = torch.as_tensor(np.array(arr, np.float32), device=dev)
        elif arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
            out[key] = _leaf_tensor(arr, dev)
        else:
            out[key] = torch.as_tensor(np.array(arr), device=dev) \
                .to(torch.int64)
    return out


def opt_state_from_reference(state, device=None):
    """The reference's ``AdamWState``/``SGDState`` (numpy leaves) as the
    port's: the step a Python int, the f32 moments as tensors."""
    from repro_torch.train.optimizer import AdamWState, SGDState
    step = int(np.asarray(state.step))
    if hasattr(state, "mom"):
        return SGDState(step=step, mom=tree_from_numpy(state.mom, device))
    return AdamWState(step=step, mu=tree_from_numpy(state.mu, device),
                      nu=tree_from_numpy(state.nu, device))


# ---------------------------------------------------- the quasi-Newton path

def tree_draws_from_numpy(draws: Mapping, device=None) -> Dict:
    """The reference's pytree-engine draws, ``{transmission name: tree of
    standard normals (m, *leaf)}`` as numpy, as the ``noise=`` or
    ``attack_noise=`` argument of ``protocol_tree_rounds`` and the QN
    train step."""
    return {name: tree_from_numpy(tree, device)
            for name, tree in draws.items()}


def lbfgs_memory_from_reference(mem, device=None):
    """A reference ``LBFGSMemory`` (numpy leaves; ``s_hist``/``y_hist``
    trees or flat arrays, ``count`` int32) as the port's."""
    from repro_torch.core.bfgs import LBFGSMemory
    dev = resolve_device(device)
    return LBFGSMemory(tree_from_numpy(mem.s_hist, dev),
                       tree_from_numpy(mem.y_hist, dev),
                       torch.as_tensor(np.array(mem.count, np.int32),
                                       device=dev))
