"""Checkpointing: flat-path ``.npz`` snapshots with an atomic rename —
``repro/checkpoint/checkpoint.py`` counterpart, with the reference's keys,
so a checkpoint written by one package restores in the other.

Keys: ``params/<path>`` (``params/embed``, ``params/layers/attn/w_q``, ...),
``opt/<path>`` for the optimizer state (``opt/.step``, ``opt/.mu/<path>``,
``opt/.nu/<path>``: a named tuple's fields are ``.<field>``, as
``jax.tree_util`` names them; the quasi-Newton path's ``LBFGSMemory`` is
``opt/0/<path>`` for ``s_hist``, ``opt/1/<path>`` for ``y_hist`` and
``opt/2`` for ``count``, its registered children's indices), ``__step__``
and ``__meta__`` (JSON bytes).
Paths join dict keys (sorted) and sequence indices with ``/``.

numpy has no bfloat16: the reference writes a bf16 leaf as two raw bytes
per value (dtype ``|V2``), and so does this, through a 16-bit integer
view, so the bytes cross exactly. (The reference's own ``restore`` cannot
cast ``|V2`` back to bfloat16; this one reads it through the same view.)
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.bfgs import LBFGSMemory


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """``(name, child)`` pairs of a tree node, None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, LBFGSMemory):
        return [("0", node.s_hist), ("1", node.y_hist), ("2", node.count)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(node)]
    return None


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    kids = _children(tree)
    if kids is None:
        out[prefix.rstrip("/")] = tree
        return
    for name, child in kids:
        _flatten(child, f"{prefix}{name}/", out)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, int):           # an optimizer's step
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like) -> Any:
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item()) if arr.ndim == 0 else arr
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, params: Any, opt_state: Any = None, step: int = 0,
         meta: Optional[Dict] = None) -> None:
    """Write ``params``, ``opt_state`` (optional), ``step`` and ``meta`` to
    ``path`` (written beside it, then renamed into place)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat: Dict[str, Any] = {}
    _flatten(params, "params/", flat)
    if opt_state is not None:
        _flatten(opt_state, "opt/", flat)
    payload = {k: _to_numpy(v) for k, v in flat.items()}
    payload["__step__"] = np.asarray(step)
    payload["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(),
                                        dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def _fill(z, node, prefix: str):
    kids = _children(node)
    if kids is None:
        key = prefix.rstrip("/")
        arr = z[key]
        shape = tuple(node.shape) if isinstance(node, torch.Tensor) else ()
        if tuple(arr.shape) != shape:
            raise ValueError(f"shape mismatch at {key}: ckpt {arr.shape} vs "
                             f"template {shape}")
        return _from_numpy(arr, node)
    vals = [_fill(z, child, f"{prefix}{name}/") for name, child in kids]
    if isinstance(node, dict):
        return dict(zip((k for k, _ in kids), vals))
    if isinstance(node, LBFGSMemory):
        return LBFGSMemory(*vals)
    if _is_namedtuple(node):
        return type(node)(*vals)
    return type(node)(vals)


def restore(path: str, params_like: Any, opt_like: Any = None
            ) -> Tuple[Any, Any, int, Dict]:
    """``(params, opt_state, step, meta)`` read into the structure of the
    templates: each leaf in its template's dtype and on its device, shapes
    checked (``ValueError`` on a mismatch)."""
    with np.load(path) as z:
        step = int(z["__step__"])
        meta = json.loads(bytes(z["__meta__"]).decode() or "{}")
        params = _fill(z, params_like, "params/")
        opt_state = _fill(z, opt_like, "opt/") \
            if opt_like is not None else None
    return params, opt_state, step, meta
