"""The protocol's wire: noise, corrupt and aggregate primitives over a flat
array or a parameter pytree — ``repro/core/transport.py`` counterpart.

Algorithm 1's wire model: a per-machine statistic is stacked along a
machine axis, DP noise is added per machine, Byzantine corruption replaces
the selected rows, and a robust aggregator reduces the machine axis.

Two layouts:

* **Flat** (the protocol): ``values`` is one tensor ``(*B, m, p)`` with the
  machine axis second to last; leading axes are batch (the Monte-Carlo
  replicate axis). A 1-D ``(m,)`` stack is a statistic with an empty
  payload. An ``(m, p)`` array is the reference's layout exactly.
* **Pytree** (serving): ``values`` is a nested ``dict``/``list``/``tuple``
  of tensors ``(m, *payload)``, machine axis first. Every primitive works
  leaf by leaf; at the aggregation boundary each leaf is reshaped to
  ``(m, d_leaf)`` and back. Dict keys are visited in sorted order, as
  ``jax.tree_util`` visits them, so leaf order and :func:`leaf_paths`
  equal the reference's.
"""
from __future__ import annotations

import contextvars
import math
from typing import Any, Callable, List, Optional, Tuple, Union

import torch

from repro_torch import agg, attacks, obs
from repro_torch.attacks.rules import Key

__all__ = ["tree_flatten", "tree_unflatten", "tree_map", "tree_leaves",
           "tree_leaves_like", "leaf_paths", "is_single_leaf",
           "tree_leaf_dims", "tree_size",
           "tree_axpy", "tree_sub", "tree_add", "tree_scale", "tree_dot",
           "leaf_sum", "active_payload", "wire_noise", "wire_corrupt",
           "wire_aggregate"]

#: the payload sharding of the step that is running (a
#: ``dist.payload.Payload``, set by its ``active()``), or None: every leaf
#: whole on this rank
_PAYLOAD: contextvars.ContextVar = contextvars.ContextVar("payload",
                                                          default=None)


def active_payload():
    """The ``dist.payload.Payload`` this step runs under, or None."""
    return _PAYLOAD.get()


# ------------------------------------------------------------ tree helpers

def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _flatten(node, leaves: list):
    if isinstance(node, dict):
        keys = sorted(node)
        return (dict, keys, [_flatten(node[k], leaves) for k in keys])
    if isinstance(node, (list, tuple)):
        return (type(node), None, [_flatten(x, leaves) for x in node])
    leaves.append(node)
    return None


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` of a nested ``dict``/``list``/``tuple``;
    anything else is a leaf. Dict keys are visited sorted. (The walks are
    module functions, not recursive closures: a closure that calls itself
    is a reference cycle, which would keep the leaves, and with them a
    model's worth of device memory, alive until the cyclic collector
    runs.)"""
    leaves: List[Any] = []
    return leaves, _flatten(tree, leaves)


def _build(node, it):
    if node is None:
        return next(it)
    kind, keys, kids = node
    if kind is dict:
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    return kind(_build(c, it) for c in kids)


def tree_unflatten(treedef: Any, leaves) -> Any:
    """The tree of ``treedef`` (from :func:`tree_flatten`) holding
    ``leaves`` in order."""
    return _build(treedef, iter(leaves))


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def _up_to(node, tree, out: list) -> None:
    if node is None:
        out.append(tree)
        return
    kind, keys, kids = node
    items = [tree[k] for k in keys] if kind is dict else list(tree)
    for kid, item in zip(kids, items):
        _up_to(kid, item, out)


def tree_leaves_like(tree: Any, like: Any) -> List[Any]:
    """The entries of ``tree`` at the leaves of ``like`` (same structure
    down to them), in leaf order: a leaf of ``tree`` may itself be a
    tuple, such as a sharding spec."""
    out: List[Any] = []
    _up_to(tree_flatten(like)[1], tree, out)
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree in ``rest`` (same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def _paths(node, path: tuple, out: list) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _paths(node[k], path + (str(k),), out)
    elif isinstance(node, (list, tuple)):
        for i, x in enumerate(node):
            _paths(x, path + (str(i),), out)
    else:
        out.append("/".join(path) or "theta")


def leaf_paths(tree: Any) -> List[str]:
    """Leaf names in leaf order, as the reference writes them: dict keys
    and sequence indices joined by ``/`` (``"layers/0/w_q"``), and
    ``"theta"`` for a tree that is a single array."""
    out: List[str] = []
    _paths(tree, (), out)
    return out


def is_single_leaf(tree: Any) -> bool:
    return len(tree_leaves(tree)) == 1


def tree_leaf_dims(tree: Any, machine_axis: bool = False) -> Any:
    """Per-leaf flat dimension d_leaf (ints, same tree structure); with
    ``machine_axis=True`` the leading machine axis is excluded."""
    def dim(leaf):
        shape = tuple(leaf.shape)[1:] if machine_axis else tuple(leaf.shape)
        return int(math.prod(shape)) if shape else 1
    return tree_map(dim, tree)


def tree_size(tree: Any, machine_axis: bool = False) -> int:
    """Total transmitted dimension: the sum of the per-leaf dims."""
    return sum(tree_leaves(tree_leaf_dims(tree, machine_axis=machine_axis)))


# ------------------------------------------------------------ tree algebra

def leaf_sum(parts: List[Any]):
    """The sum over a parameter tree of per-leaf partial sums, ``parts`` in
    leaf order. Under a payload sharding (:func:`active_payload`) a leaf
    sharded over the model axis holds a slice on this rank, so its parts
    are summed over the model group, and a replicated leaf is counted
    once."""
    pl = _PAYLOAD.get()
    return sum(parts) if pl is None else pl.leaf_sum(parts)


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    """Global inner product ``<a, b>`` over matching trees: a Python sum of
    per-leaf dot products, each in the leaves' own dtype (a bf16 tree gives
    a bf16 scalar, as the reference's ``jnp.vdot`` does), through
    :func:`leaf_sum`."""
    return leaf_sum([torch.dot(x.reshape(-1), y.reshape(-1))
                     for x, y in zip(tree_leaves(a), tree_leaves(b))])


def tree_add(a: Any, b: Any) -> Any:
    return tree_map(torch.add, a, b)


def tree_sub(a: Any, b: Any) -> Any:
    return tree_map(torch.sub, a, b)


def tree_scale(c, a: Any) -> Any:
    """``c * a``, leaf by leaf (``c`` a number or a 0-d tensor)."""
    return tree_map(lambda x: c * x, a)


def tree_axpy(c: float, x: Any, y: Any) -> Any:
    """``y + c * x``, leaf by leaf (a new tree)."""
    return tree_map(lambda xx, yy: yy + c * xx, x, y)


def _match(tree: Any, value: Any) -> list:
    """``value`` (a number, a per-machine vector or a tree matching
    ``tree``) as one entry per leaf of ``tree``, in leaf order."""
    leaves, treedef = tree_flatten(tree)
    if _is_node(value) and tree_flatten(value)[1] == treedef:
        return tree_leaves(value)
    return [value] * len(leaves)


# ----------------------------------------------------------- the wire ops

def _bcast_sigma(sig, values: torch.Tensor):
    """A number, or a per-machine sigma tensor whose LAST axis is the
    machine axis (size m, or 1 for one sigma per batch row), broadcast over
    the payload axis."""
    if not isinstance(sig, torch.Tensor) or sig.dim() == 0:
        return sig
    return sig.to(values.dtype).unsqueeze(-1)


def _leaf_sigma(sig, leaf: torch.Tensor):
    """A number, or a per-machine ``(m,)`` sigma broadcast over the
    payload of a machine-first leaf."""
    if not isinstance(sig, torch.Tensor) or sig.dim() == 0:
        return sig
    return sig.to(leaf.dtype).reshape((-1,) + (1,) * (leaf.dim() - 1))


def _noised(z, x: torch.Tensor, s) -> torch.Tensor:
    """``x + s * z``, z standard normals or a generator's next draw; the
    draw at a number ``s`` is noised in its own buffer, so no second
    buffer of ``x``'s size is made."""
    if not isinstance(z, torch.Generator):
        # repro-torch: allow(step-sync) — a device draw table passes through
        # uncopied; host tables (the parity tests' draws) are copied
        return x + s * z.to(dtype=x.dtype, device=x.device)
    z = torch.randn(x.shape, generator=z, dtype=x.dtype, device=x.device)
    return x + s * z if isinstance(s, torch.Tensor) else z.mul_(s).add_(x)


def wire_noise(z: Union[Key, Any], values: Any, sigma: Any) -> Any:
    """Gaussian mechanism on the wire: ``values + sigma * z``, one draw per
    machine row and coordinate.

    Flat: ``z`` is standard normals shaped like the noised output, which
    may carry batch axes that ``values`` broadcasts over, or a generator;
    ``sigma`` a number or per-machine ``(*B, m)``. Pytree: ``z`` is a
    generator (one draw per leaf, in leaf order) or a tree of standard
    normals matching ``values``; ``sigma`` a number, a per-machine ``(m,)``
    vector or a tree of those matching ``values``."""
    with obs.span("repro.wire.noise"):
        if isinstance(values, torch.Tensor):
            return _noised(z, values, _bcast_sigma(sigma, values))
        leaves, treedef = tree_flatten(values)
        zs = [z] * len(leaves) if isinstance(z, torch.Generator) \
            else tree_leaves(z)
        noisy = [_noised(zz, leaf, _leaf_sigma(s, leaf))
                 for leaf, s, zz in zip(leaves, _match(values, sigma), zs)]
        return tree_unflatten(treedef, noisy)


def wire_corrupt(key: Optional[Key], values: Any,
                 byz_mask: Optional[torch.Tensor], attack: str = "scale",
                 factor=-3.0, round_idx: int = 0) -> Any:
    """Byzantine corruption of the machine rows selected by ``byz_mask
    (m,)`` through the ``repro_torch.attacks`` registry.

    Flat: ``values`` is ``(*B, m, p)``; omniscient attacks see each batch
    row's full machine axis; ``key`` (attacks that draw) is a generator or
    standard normals shaped like ``values``. Pytree: one attack call per
    leaf ``(m, *payload)``; ``key`` is a generator (drawn from leaf by
    leaf) or a tree of standard normals matching ``values``."""
    if byz_mask is None or attacks.resolve(attack) == "none":
        return values
    with obs.span("repro.wire.corrupt"):
        if isinstance(values, torch.Tensor):
            k = key.movedim(-2, 0) if isinstance(key, torch.Tensor) \
                else key
            out = attacks.apply_attack(values.movedim(-2, 0), byz_mask,
                                       attack=attack, factor=factor, key=k,
                                       round_idx=round_idx)
            return out.movedim(0, -2)
        leaves, treedef = tree_flatten(values)
        keys = tree_leaves(key) if _is_node(key) else [key] * len(leaves)
        out = [attacks.apply_attack(leaf, byz_mask, attack=attack,
                                    factor=factor, key=k,
                                    round_idx=round_idx)
               for leaf, k in zip(leaves, keys)]
        return tree_unflatten(treedef, out)


def wire_aggregate(values: Any, method: str, scale: Any = None,
                   K: int = 10, trim_beta: float = 0.2,
                   backend: Optional[str] = None,
                   fill: Optional[int] = None) -> Any:
    """Robust aggregation of the machine axis through the
    ``repro_torch.agg`` registry.

    Flat (no ``fill``): ``(m,) -> ()`` or ``(*B, m, p) -> (*B, p)`` with
    ``scale`` shaped like the result; the whole batch is one kernel launch
    on a CUDA tensor. Pytree: each leaf ``(m, *payload)`` is reshaped to
    ``(m, d_leaf)``, aggregated, and reshaped back to ``payload`` in the
    leaf's dtype; ``scale`` is a number or a tree matching ``values``.

    ``fill`` (serving): the leading axis is a ring buffer whose first
    ``fill`` rows are valid, and every leaf goes to
    ``agg.aggregate_masked``, where ``backend`` is ``"sort"``, ``"bisect"``
    or None; a single array passes through at its native shape."""
    if fill is not None:
        if isinstance(values, torch.Tensor):
            return agg.aggregate_masked(values, fill, method=method,
                                        scale=scale, K=K,
                                        trim_beta=trim_beta, axis=0,
                                        backend=backend)
        leaves, treedef = tree_flatten(values)
        out = [agg.aggregate_masked(leaf, fill, method=method, scale=sc,
                                    K=K, trim_beta=trim_beta, axis=0,
                                    backend=backend)
               for leaf, sc in zip(leaves, _match(values, scale))]
        return tree_unflatten(treedef, out)
    if isinstance(values, torch.Tensor):
        if values.dim() == 1:
            return agg.aggregate(values, method=method, scale=scale, K=K,
                                 trim_beta=trim_beta, axis=0,
                                 backend=backend)
        return agg.aggregate_batched(values, method=method, scale=scale,
                                     K=K, trim_beta=trim_beta,
                                     backend=backend)
    leaves, treedef = tree_flatten(values)
    out = []
    for leaf, sc in zip(leaves, _match(values, scale)):
        payload = leaf.shape[1:]
        flat = leaf.reshape(leaf.shape[0], -1)
        # repro-torch: allow(step-sync) — a device scale passes through
        # uncopied; only a host number is copied to the card
        fsc = None if sc is None else torch.as_tensor(
            sc, dtype=leaf.dtype, device=leaf.device).broadcast_to(
            payload).reshape(-1)
        red = agg.aggregate(flat, method=method, scale=fsc, K=K,
                            trim_beta=trim_beta, axis=0, backend=backend)
        out.append(red.reshape(payload).to(leaf.dtype))
    return tree_unflatten(treedef, out)
