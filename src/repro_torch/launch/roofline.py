"""Roofline analysis of one rank's step traced on the meta device — the
H100 counterpart of ``repro/launch/roofline.py``.

Three terms per (arch x shape x mesh), all in seconds per step:

    compute    = FLOPs per device / PEAK_FLOPS_BF16
    memory     = bytes per device / HBM_BW
    collective = bytes over "model" / NVLINK_BW
                 + bytes over "data" and "pod" / IB_BW

The reference reads FLOPs and bytes from XLA's cost analysis of the
compiled SPMD module and collective bytes from its HLO text. The port's
step is eager PyTorch, so :class:`CountingMode`, a ``TorchDispatchMode``
around one rank's step on meta tensors (which compute nothing), counts
what that step dispatches:

  * FLOPs by ``torch.utils.flop_counter``'s formulas, the same that
    ``FlopCounterMode`` applies around a real step; attention by the SDPA
    formula with GQA (:data:`SDPA_FORMULAS`, which the card's
    ``FlopCounterMode`` is given too);
  * bytes per op, every input read once and every output written once,
    which is what eager PyTorch moves without fusion (views move
    nothing; ``empty`` writes nothing);
  * the hand kernels as one op each, by their bound: B1
    (``agg.kernel.ostat_trace``) its ``(N, m, p)`` f32 input and outputs,
    B2 (``kernels.gqa_decode.gqa_decode_trace``) q, K and V over the
    cache's slots and the output (the dry run's cache is full: pos =
    S - 1). Neither adds FLOPs, as ``FlopCounterMode`` sees none on the
    card;
  * the live bytes of every storage, from the tensors that exist before
    the step (:meth:`CountingMode.track`) and every op's outputs until
    they are freed (autograd's saved tensors included): the peak;
  * each collective of ``dist.collectives.MeshAxis`` on the mapping
    mesh, one ``repro_torch::collective`` op in the trace, by its result
    bytes (as the reference counts HLO result shapes) and the axis it
    crosses: a change to the collectives changes the count.

A meta tensor holds no values, so where the step reads one on the host
(the QN step's curvature test, ``s . y > 1e-10``, picks the machines
that push) the counting mode reads ones: the trace takes the branch in
which every test passes.

MODEL_FLOPS (the "useful" 6ND / 2ND accounting) uses parameter counts
from the model built on the meta device, with the reference's MoE
active-parameter correction. The reference's ``parse_collective_bytes``,
``module_costs`` and ``extrapolate_layers`` read XLA's HLO and correct its
scan-once cost analysis; the port's Python loop over layers is traced
whole, so they have no counterpart.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.transport import tree_leaves
from repro_torch.launch import mesh as meshmod

__all__ = ["SDPA_FORMULAS", "CountingMode", "count_params", "model_flops",
           "RooflineReport", "analyze", "axis_link", "tensors_of"]

aten = torch.ops.aten


def _bmm(b: int, n: int, k: int, m: int) -> int:
    return 2 * b * n * k * m


def _sdpa_fwd(q, k, v, *args, out_shape=None, **kwargs) -> int:
    """QK^T and PV at the query's heads (GQA: the KV heads broadcast)."""
    b, h, s_q, d = q[:4]
    s_k, d_v = k[2], v[3]
    return _bmm(b * h, s_q, d, s_k) + _bmm(b * h, s_q, s_k, d_v)


def _sdpa_bwd(g, q, k, v, *args, out_shape=None, **kwargs) -> int:
    """The scores recomputed, then the gradients of PV and QK^T."""
    b, h, s_q, d = q[:4]
    s_k, d_v = k[2], v[3]
    return (_bmm(b * h, s_q, d, s_k) + _bmm(b * h, s_q, d_v, s_k)
            + _bmm(b * h, s_k, s_q, d_v) + _bmm(b * h, s_q, s_k, d)
            + _bmm(b * h, d, s_q, s_k))


#: the fused attention ops' FLOPs with GQA (the card's torch 2.11 counts
#: them only at equal heads, and no release counts the CPU's flash op):
#: ``FlopCounterMode(custom_mapping=SDPA_FORMULAS)``
SDPA_FORMULAS = {
    aten._scaled_dot_product_flash_attention_for_cpu: _sdpa_fwd,
    aten._scaled_dot_product_flash_attention_for_cpu_backward: _sdpa_bwd,
    aten._scaled_dot_product_flash_attention: _sdpa_fwd,
    aten._scaled_dot_product_efficient_attention: _sdpa_fwd,
    aten._scaled_dot_product_cudnn_attention: _sdpa_fwd,
    aten._scaled_dot_product_flash_attention_backward: _sdpa_bwd,
    aten._scaled_dot_product_efficient_attention_backward: _sdpa_bwd,
    aten._scaled_dot_product_cudnn_attention_backward: _sdpa_bwd,
}


def _registry():
    from torch.utils.flop_counter import flop_registry, shape_wrapper
    return {**flop_registry,
            **{k: shape_wrapper(v) for k, v in SDPA_FORMULAS.items()}}


_FACTORIES = {aten.empty, aten.empty_like, aten.empty_strided,
              aten.new_empty, aten.new_empty_strided}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def tensors_of(x) -> list:
    """The tensors under ``x``: a tensor, a dict, list or tuple (a
    ``NamedTuple`` such as ``AdamWState`` among them) or a dataclass (such
    as ``LBFGSMemory``) of those."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        x = [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (dict, list, tuple)):
        items = x.values() if isinstance(x, dict) else x
        return [t for item in items for t in tensors_of(item)]
    return [x] if isinstance(x, torch.Tensor) else []


def axis_link(axis: str) -> str:
    """The network a collective over ``axis`` crosses: "nvlink" for the
    model axis (one node's eight cards), "ib" for the rest."""
    return "nvlink" if axis == "model" else "ib"


class CountingMode(TorchDispatchMode):
    """Counts FLOPs, bytes, kernel launches, collective bytes and live
    bytes of what runs inside it (see the module docstring). Use as a
    context manager around one rank's step on the meta device; call
    :meth:`track` first on every tree that exists before the step."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernel_bytes: Counter = Counter()
        self.launches: Counter = Counter()
        self.collectives: Counter = Counter()   # (kind, axis) -> bytes
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        self._registry = _registry()
        from repro_torch.agg import kernel as _b1  # noqa: F401 (the ops)
        from repro_torch.kernels import gqa_decode as _b2  # noqa: F401
        from repro_torch.dist import collectives  # noqa: F401 (the op)
        self._kernels = {torch.ops.repro_torch.ostat.default: "ostat",
                         torch.ops.repro_torch.gqa_decode.default:
                             "gqa_decode"}
        self._collective = torch.ops.repro_torch.collective.default

    # ------------------------------------------------------ live bytes
    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def track(self, *trees: Any) -> "CountingMode":
        """Count the storages of ``trees`` as live from now on."""
        for tree in trees:
            for t in tensors_of(tree):
                self._hold(t)
        return self

    # ----------------------------------------------------- collectives
    def record_collective(self, kind: str, axis: str, nbytes: int) -> None:
        self.collectives[(kind, axis)] += nbytes

    # ------------------------------------------------------- the ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        x = args[0] if args else None
        if isinstance(x, torch.Tensor) and x.is_meta:
            # a host read of a meta tensor reads ones (module docstring)
            if func is aten._local_scalar_dense.default:
                return True if x.dtype == torch.bool else 1
            dev = kwargs.get("device")
            if func is aten._to_copy.default and dev is not None \
                    and torch.device(dev).type != "meta":
                return torch.ones(x.shape, dtype=kwargs.get("dtype", x.dtype),
                                  device=dev)
        out = func(*args, **kwargs)
        if func is self._collective:
            self.record_collective(args[1], args[2], _nbytes(out))
        outs = tensors_of(out)
        ins = tensors_of((args, kwargs))
        kernel = self._kernels.get(func)
        views = any(r.alias_info is not None and not r.alias_info.is_write
                    for r in func._schema.returns)
        if kernel is not None:
            moved = sum(_nbytes(t) for t in ins[:3] + outs)
            self.kernel_bytes[kernel] += moved
            self.bytes += moved
            self.launches[kernel] += 1
        elif not views:
            self.ops += 1
            packet = func._overloadpacket
            if packet in self._registry:
                self.flops += int(self._registry[packet](*args, **kwargs,
                                                         out_val=out))
            if packet not in _FACTORIES:
                self.bytes += sum(_nbytes(t) for t in ins + outs)
        if not views:
            for t in outs:
                self._hold(t)
        return out

    def collective_bytes(self) -> Dict[str, int]:
        """``{kind: bytes}`` over every axis, and ``total``, ``nvlink``
        and ``ib``."""
        out: Dict[str, int] = Counter()
        for (kind, axis), n in self.collectives.items():
            out[kind] += n
            out[axis_link(axis)] += n
            out["total"] += n
        return dict(out)


def count_params(cfg: ModelConfig) -> Dict[str, int]:
    """Total and active parameter counts (active: MoE uses top_k
    experts), from the model built on the meta device."""
    from repro_torch.models.model import Model
    total = sum(math.prod(t.shape) for t in
                tree_leaves(Model(cfg, device="meta").params()))
    active = total
    if cfg.moe is not None:
        per_expert = 3 * cfg.d_model * cfg.moe.d_ff_expert
        inactive = (cfg.moe.n_experts - cfg.moe.top_k) * per_expert \
            * cfg.n_layers
        active = total - inactive
    return {"total": total, "active": active}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6 * N_active * D for training, 2 * N_active * D for an inference
    forward (prefill: every token; decode: one token a sequence)."""
    n = count_params(cfg)["active"]
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    peak_memory_bytes: Optional[float] = None
    collective_nvlink_s: float = 0.0
    collective_ib_s: float = 0.0

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def analyze(counts: CountingMode, cfg: ModelConfig, shape: ShapeConfig,
            mesh_name: str, chips: int, arch: str) -> RooflineReport:
    """The report of one traced step (``counts``) on ``chips`` cards, by
    the datasheet constants of ``launch.mesh`` (a prediction, not a
    measurement)."""
    coll = counts.collective_bytes()
    compute_s = counts.flops / meshmod.PEAK_FLOPS_BF16
    memory_s = counts.bytes / meshmod.HBM_BW
    nvlink_s = coll.get("nvlink", 0) / meshmod.NVLINK_BW
    ib_s = coll.get("ib", 0) / meshmod.IB_BW
    collective_s = nvlink_s + ib_s
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_per_device=float(counts.flops),
        bytes_per_device=float(counts.bytes), collective_bytes=coll,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf,
        useful_ratio=mf / max(counts.flops * chips, 1.0),
        peak_memory_bytes=float(counts.peak),
        collective_nvlink_s=nvlink_s, collective_ib_s=ib_s)
