"""Partitioning rules: parameter, batch and cache specs for any mesh —
``repro/models/sharding.py`` counterpart, as pure shape rules.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``) or a plain mapping ``{axis name:
size}`` in axis order, so the rules need no process group. A spec is a
tuple with one entry per dim: an axis name, a tuple of names, or ``None``
(the reference's ``PartitionSpec`` entries as a plain tuple).

Scheme (Megatron-style, as the reference's):
  * "model" shards fused attention head dims (w_q/w_k/w_v out, w_o in),
    MLP d_ff (w_gate/w_up out, w_down in), vocab (embed rows, lm_head
    cols), the MoE expert axis, Mamba d_inner.
  * "data" (x "pod") shards the batch / machine axis of activations,
    gradients and KV caches.
  * Norms, biases, router, small SSM scalars are replicated.

Every rule is checked against the mesh: a dim that does not divide falls
back to the next candidate or to replication. The port runs the machine
axis only (``dist/``); sharding payload dims over "model" or "data" is
ROADMAP A12, and these rules are what its dry run will read.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

from repro_torch.core.transport import leaf_paths, tree_leaves, tree_map

__all__ = ["mesh_shape", "param_spec", "param_shardings", "batch_axes",
           "data_spec", "batch_shardings", "cache_spec", "cache_shardings",
           "explain_specs", "format_spec"]

Spec = Tuple[Any, ...]

# key name -> the dim to shard on "model", counted from the END of the
# shape (a leading layer axis shifts positive indices, not negative ones)
_RULES: Dict[str, int] = {
    "w_q": -1, "w_k": -1, "w_v": -1, "w_gate": -1, "w_up": -1,
    "w_in": -1, "w_x": -1, "w_if": -1, "lm_head": -1, "projector": -1,
    "w_router": -1,
    "w_o": -2, "w_down": -2, "w_out": -2,
    "embed": -2,
}

_REPLICATED = {"norm1", "norm2", "norm", "norm_f", "conv_w", "conv_b",
               "a_log", "dt_bias", "d_skip", "b_if", "b", "r_h"}


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` in axis order, of a ``DeviceMesh`` or of a
    mapping (returned as a dict)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named dims (mesh_dim_names)")
    return dict(zip(names, tuple(mesh.shape)))


def _axis_size(shape: Dict[str, int], name) -> int:
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= shape[n]
        return out
    return shape[name]


def _fits(dims: Tuple[int, ...], dim: int, shape: Dict[str, int],
          axis) -> bool:
    try:
        return dims[dim] % _axis_size(shape, axis) == 0
    except (IndexError, KeyError):
        return False


def param_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh: Any,
               cfg: Optional[Any] = None, fsdp: bool = False) -> Spec:
    """The spec of one parameter leaf given its path (dict keys and list
    indices as strings). ``fsdp=True`` also shards the largest remaining
    dim that divides over a "data" axis (ZeRO-3 style), valid only where
    "data" is not the machine axis. ``cfg`` is the reference's unused
    argument."""
    axes = mesh_shape(mesh)
    name = path[-1]
    ndim = len(shape)
    spec = [None] * ndim
    if name in _REPLICATED or ndim == 0:
        return tuple(spec)
    if "moe" in path and name in ("w_gate", "w_up", "w_down"):
        # MoE expert tensors (L?, E, d, f): the expert axis, dim -3
        if _fits(shape, ndim - 3, axes, "model"):
            spec[ndim - 3] = "model"
    elif name in _RULES:
        dim = _RULES[name] % ndim
        if _fits(shape, dim, axes, "model"):
            spec[dim] = "model"
    if fsdp and "data" in axes:
        for dim in sorted(range(ndim), key=lambda i: -shape[i]):
            if spec[dim] is None and _fits(shape, dim, axes, "data"):
                spec[dim] = "data"
                break
    return tuple(spec)


def _path_tuples(tree: Any):
    return [tuple(p.split("/")) for p in leaf_paths(tree)]


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def param_shardings(params: Any, mesh: Any, cfg: Optional[Any] = None,
                    fsdp: bool = False) -> Any:
    """The tree of specs matching ``params`` (tensors of any device, the
    meta device included)."""
    specs = iter([param_spec(path, _shape(leaf), mesh, cfg, fsdp=fsdp)
                  for path, leaf in zip(_path_tuples(params),
                                        tree_leaves(params))])
    return tree_map(lambda _: next(specs), params)


def batch_axes(mesh: Any):
    """The (possibly compound) batch axis: ``("pod", "data")`` when a pod
    axis exists, else ``"data"``."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else "data"


def data_spec(shape: Tuple[int, ...], mesh: Any, batch_dim: int = 0) -> Spec:
    """The batch dim over pod x data where it divides (else data alone,
    else replicated)."""
    axes = mesh_shape(mesh)
    ax = batch_axes(axes)
    spec = [None] * len(shape)
    if _fits(shape, batch_dim, axes, ax):
        spec[batch_dim] = ax
    elif not isinstance(ax, str) and _fits(shape, batch_dim, axes, "data"):
        spec[batch_dim] = "data"
    return tuple(spec)


def batch_shardings(batch: Any, mesh: Any, batch_dim: int = 0) -> Any:
    return tree_map(lambda leaf: data_spec(_shape(leaf), mesh, batch_dim),
                    batch)


def cache_spec(path: Tuple[str, ...], shape: Tuple[int, ...], mesh: Any,
               kv_mode: str = "auto") -> Spec:
    """KV and state caches, ``(L, B, ...)``: batch on data, heads (or head
    dim) on model where they divide. ``kv_mode``: ``auto`` (heads, else
    head dim), ``seq`` (the cache's sequence axis on model) or
    ``replicate`` (nothing on model)."""
    ndim = len(shape)
    if ndim == 0:
        return ()
    axes = mesh_shape(mesh)
    name = path[-1]
    spec = [None] * ndim
    ax = batch_axes(axes)
    if any("xlstm" in str(s) for s in path):
        # per-layer lists with the batch leading
        if _fits(shape, 0, axes, ax):
            return (ax,) + (None,) * (ndim - 1)
        return tuple(spec)
    bdim = 1 if ndim >= 2 else 0
    if _fits(shape, bdim, axes, ax):
        spec[bdim] = ax
    elif not isinstance(ax, str) and _fits(shape, bdim, axes, "data"):
        spec[bdim] = "data"
    if name in ("k", "v") and ndim >= 4:
        # (L, B, S, Hkv, dh)
        if kv_mode == "seq":
            if _fits(shape, ndim - 3, axes, "model"):
                spec[ndim - 3] = "model"
        elif kv_mode == "auto":
            if _fits(shape, ndim - 2, axes, "model"):
                spec[ndim - 2] = "model"
            elif _fits(shape, ndim - 1, axes, "model"):
                spec[ndim - 1] = "model"
    elif name in ("state", "conv", "C", "n") and ndim >= 3:
        # ssm state (L,B,H,N,dh), conv (L,B,t,C), the mLSTM's C: dim 2
        if _fits(shape, 2, axes, "model"):
            spec[2] = "model"
    return tuple(spec)


def cache_shardings(cache: Any, mesh: Any, kv_mode: str = "auto") -> Any:
    """The tree of specs matching ``cache`` (a Python int, such as the
    port's ``pos``, is a scalar)."""
    specs = iter([cache_spec(path, _shape(leaf), mesh, kv_mode=kv_mode)
                  for path, leaf in zip(_path_tuples(cache),
                                        tree_leaves(cache))])
    return tree_map(lambda _: next(specs), cache)


def format_spec(spec: Spec) -> str:
    """A spec written as the reference prints its ``PartitionSpec``."""
    return f"PartitionSpec{tuple(spec)!r}"


def explain_specs(params: Any, mesh: Any) -> Dict[str, str]:
    """``{leaf path: spec}``, the spec as :func:`format_spec` writes it."""
    return {"/".join(path): format_spec(param_spec(path, _shape(leaf), mesh))
            for path, leaf in zip(_path_tuples(params), tree_leaves(params))}
