"""Batched order-statistics aggregation: the CUDA kernel's wrapper and its
plain PyTorch version — ``repro/agg/kernel.py`` counterpart.

One kernel (``csrc/ostat.cu``) serves every coordinate-wise aggregator:
mean, k-th order statistic, median, trimmed mean, scale-supplied DCQ,
MAD-scaled DCQ and the fused median+MAD+DCQ pass, all built from one
bisection rank-counting core, ``(*B, m, p) -> (*B, p)`` with the machine
axis second to last and any leading axes batch.

* :func:`ostat` is the wrapper. On a CUDA tensor it launches the kernel
  (building it with ``nvcc`` at first use) or raises; it never falls back.
  On a CPU tensor it runs :func:`ostat_plain`.
* :func:`ostat_plain` is the same algorithm in eager PyTorch, mirroring
  the reference's ``_kth_smallest``, ``_median_cols``, ``_trimmed_cols``
  and ``_cq_correct``: the same fp32 halvings, so ``kth`` and ``median``
  agree with the kernel bit for bit, and the sum-based ops up to
  summation order.
* :func:`ostat_plan` lays a launch out on the card: how many lanes share a
  coordinate, and whether each lane's rows sit in registers, in the
  staged shared-memory slab or in device memory. ``ostat(lanes=)`` sets
  the lane count itself (one of :func:`lane_counts`), which the measured
  dispatch table does per shape bucket: a layout, the same result up to
  summation order.
* ``launches`` counts the kernel launches made through :func:`ostat`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from pathlib import Path
from statistics import NormalDist
from typing import List

import torch

from repro_torch.agg.reference import MAD_EPS, MAD_SIGMA
from repro_torch.cuda_build import CudaLibrary

#: default bisection trip count: enough halvings to pin any fp32 value.
N_BISECT = 60

#: the ops of the kernel; their order is the op code of csrc/ostat.cu.
OPS = ("mean", "median", "kth", "trimmed", "dcq", "dcq_mad",
       "median_mad_dcq")

#: CQ knots the kernel carries by value (kMaxK in csrc/ostat.cu).
MAX_K = 64

#: kernel launches made through :func:`ostat` in this process.
launches = 0

#: rows per lane the kernel can hold in registers (template R of
#: csrc/ostat.cu), threads per block, and the shared memory a block may use
REG_ROWS = (1, 2, 4, 8)
BLOCK = 128
MAX_SMEM = 232448
#: the H100 SXM's SMs and resident threads per SM (the planner's defaults;
#: the wrapper passes what the card reports)
H100_SMS = 132
H100_THREADS_PER_SM = 2048

SOURCE = Path(__file__).resolve().parent / "csrc" / "ostat.cu"
#: where the shared library is built at first use (listed in .gitignore).
BUILD_DIR = Path(__file__).resolve().parent / "_build"


@functools.lru_cache(maxsize=MAX_K + 1)
def cq_constants(K: int):
    """Host-side composite-quantile constants: the K standard-normal knots
    ``Delta_k = Psi^{-1}(k/(K+1))`` and ``sum_k psi(Delta_k)``, as Python
    floats (computed once per K, as the reference computes them once per
    trace)."""
    nd = NormalDist()
    knots = tuple(nd.inv_cdf((k + 1.0) / (K + 1.0)) for k in range(K))
    psi_sum = sum(math.exp(-0.5 * d * d) for d in knots) \
        / math.sqrt(2.0 * math.pi)
    return knots, psi_sum


# ------------------------------------------------- plain PyTorch version
#
# vals is (N, m, tp) float32; reductions run over the machine axis -2.
# Scalars that the kernel rounds to f32 before use are rounded the same
# way here; divisions are tensor by tensor, because PyTorch turns a
# division by a Python scalar on a CUDA tensor into a reciprocal multiply.

def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # a fill, not a host-to-device copy, so the plain version can be
    # captured in a CUDA graph
    return torch.full((), x, dtype=torch.float32, device=like.device)


def _kth_smallest(vals, k: int, lo, hi, n_bisect: int = N_BISECT):
    """Bisection k-th order statistic (0-indexed) per column: the
    converged upper bracket after ``n_bisect`` halvings."""
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        cnt = (vals <= mid.unsqueeze(-2)).sum(dim=-2)
        go_right = cnt <= k
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid)
    return hi


def _kth_cols(vals, k: int, n_bisect: int = N_BISECT):
    return _kth_smallest(vals, k, vals.amin(dim=-2), vals.amax(dim=-2),
                         n_bisect)


def _median_cols(vals, n_bisect: int = N_BISECT):
    m = vals.shape[-2]
    if m % 2 == 1:
        return _kth_cols(vals, (m - 1) // 2, n_bisect)
    return 0.5 * (_kth_cols(vals, m // 2 - 1, n_bisect)
                  + _kth_cols(vals, m // 2, n_bisect))


def _mean_cols(vals):
    return vals.sum(dim=-2) / _f32(vals.shape[-2], vals)


def _trimmed_cols(vals, g: int, n_bisect: int = N_BISECT):
    """Beta-trimmed mean (g dropped per side) without sorting: bracket with
    two order statistics, recover the kept sum from masked sums with an
    exact tie correction."""
    m = vals.shape[-2]
    if g == 0:
        return _mean_cols(vals)
    t_lo = _kth_cols(vals, g, n_bisect)
    t_hi = _kth_cols(vals, m - 1 - g, n_bisect)
    le_hi = (vals <= t_hi.unsqueeze(-2)).to(torch.float32)
    le_lo = (vals <= t_lo.unsqueeze(-2)).to(torch.float32)
    top = (vals * le_hi).sum(dim=-2) - (le_hi.sum(dim=-2) - (m - g)) * t_hi
    bot = (vals * le_lo).sum(dim=-2) - (le_lo.sum(dim=-2) - g) * t_lo
    return (top - bot) / _f32(m - 2 * g, vals)


def _cq_correct(vals, med, scale, knots, psi_sum: float):
    """med - scale*S/(m*psi_sum) with
    S = sum_k sum_j [I(v_j <= med + scale*Delta_k) - kappa_k]."""
    m = vals.shape[-2]
    K = len(knots)
    s = torch.zeros_like(med)
    for j, delta in enumerate(knots):
        thr = med + scale * delta
        kappa = (j + 1.0) / (K + 1.0)
        cnt = (vals <= thr.unsqueeze(-2)).sum(dim=-2, dtype=torch.float32)
        s = s + cnt - m * kappa
    return med - scale * s / _f32(m * psi_sum, vals)


def _mad_scale(mad):
    return MAD_SIGMA * mad + MAD_EPS


def _check(values, op, scale, K, trim_beta, kth, n_bisect,
           lanes=None) -> int:
    """Validate a call; returns the trimmed mean's per-side count g."""
    if op not in OPS:
        raise ValueError(f"unknown order-statistics op {op!r}; one of {OPS}")
    if not isinstance(values, torch.Tensor) or values.dim() < 2:
        raise ValueError("need a (*batch, m, p) tensor, got "
                         f"{getattr(values, 'shape', type(values))}")
    if not values.is_floating_point():
        raise TypeError(f"need a floating-point tensor, got {values.dtype}")
    m, p = values.shape[-2:]
    if m < 1:
        raise ValueError("need at least one machine row")
    if not 0 <= K <= MAX_K:
        raise ValueError(f"K={K} outside [0, {MAX_K}]")
    if n_bisect < 0:
        raise ValueError(f"n_bisect={n_bisect} must be >= 0")
    if lanes is not None and lanes not in lane_counts(m):
        raise ValueError(f"lanes={lanes} at m={m}: one of {lane_counts(m)}")
    if op == "kth" and not 0 <= kth < m:
        raise ValueError(f"kth={kth} outside [0, {m})")
    g = max(int(trim_beta * m), 0)
    if op == "trimmed" and 2 * g >= m:
        raise ValueError(f"trim fraction {trim_beta} too large for m={m}")
    if op == "dcq":
        if scale is None:
            raise ValueError("op='dcq' needs a per-coordinate scale")
        if scale.device != values.device:
            raise ValueError(f"scale on {scale.device}, values on "
                             f"{values.device}")
        # raises if the scale does not broadcast to (*B, p)
        torch.broadcast_shapes(scale.shape, values.shape[:-2] + (p,))
    return g


def _flat(values, scale, op):
    """(N, m, p) f32 values and (N, p) f32 scale (``dcq`` only)."""
    batch = values.shape[:-2]
    m, p = values.shape[-2:]
    vals = values.to(torch.float32).reshape((-1, m, p)).contiguous()
    sc = None
    if op == "dcq":
        sc = scale.to(torch.float32).broadcast_to(batch + (p,)) \
            .reshape((-1, p)).contiguous()
    return vals, sc


@torch.library.custom_op("repro_torch::ostat", mutates_args=())
def ostat_trace(values: torch.Tensor, n_out: int) -> List[torch.Tensor]:
    """B1's launch as one op of a meta-device trace (the dry run's counting
    mode prices it by its bound: the ``(N, m, p)`` f32 input read once,
    each ``(N, p)`` output written once). It has only the meta rule: a
    tensor with data never reaches it."""
    raise RuntimeError("ostat_trace is a meta-device trace op: the kernel "
                       "launches through ostat")


@ostat_trace.register_fake
def _ostat_trace_meta(values, n_out):
    nb, _, p = values.shape
    return [values.new_empty((nb, p), dtype=torch.float32)
            for _ in range(n_out)]


def ostat_plain(values: torch.Tensor, op: str, scale=None, *, K: int = 10,
                trim_beta: float = 0.2, kth: int = 0,
                n_bisect: int = N_BISECT, lanes: int = None):
    """The kernel's algorithm in plain PyTorch, ``(*B, m, p) -> (*B, p)``,
    on whatever device ``values`` lies. Same contract as :func:`ostat`;
    ``lanes`` is checked and has nothing to lay out here."""
    g = _check(values, op, scale, K, trim_beta, kth, n_bisect, lanes)
    batch, p = values.shape[:-2], values.shape[-1]
    vals, sc = _flat(values, scale, op)
    knots, psi_sum = cq_constants(K)
    if op == "mean":
        res = (_mean_cols(vals),)
    elif op == "kth":
        res = (_kth_cols(vals, kth, n_bisect),)
    elif op == "median":
        res = (_median_cols(vals, n_bisect),)
    elif op == "trimmed":
        res = (_trimmed_cols(vals, g, n_bisect),)
    elif op == "dcq":
        med = _median_cols(vals, n_bisect)
        res = (_cq_correct(vals, med, sc, knots, psi_sum),)
    else:                                   # dcq_mad, median_mad_dcq
        med = _median_cols(vals, n_bisect)
        mad = _median_cols((vals - med.unsqueeze(-2)).abs(), n_bisect)
        dcq = _cq_correct(vals, med, _mad_scale(mad), knots, psi_sum)
        res = (dcq,) if op == "dcq_mad" else (med, mad, dcq)
    outs = tuple(r.reshape(batch + (p,)).to(values.dtype) for r in res)
    return outs if len(outs) > 1 else outs[0]


# ---------------------------------------------------------- the kernel

@dataclasses.dataclass(frozen=True)
class OstatPlan:
    """How one launch lays its coordinates on the card.

    ``lanes`` lanes (a power of two <= 32) own one coordinate; lane s holds
    machine rows s, s + lanes, ... . ``reg_rows`` > 0: those rows sit in
    registers (``ceil(m / lanes) <= reg_rows``); 0: they are read from the
    block's slab in shared memory (``slab``) or from device memory."""
    lanes: int
    reg_rows: int
    slab: bool


def lane_counts(m: int) -> tuple:
    """The lane counts the kernel runs at ``m`` machine rows: every power
    of two up to 32 that leaves at most ``REG_ROWS[-1]`` rows to a lane,
    and 32, whose lanes read their rows from the slab or device memory
    where they do not fit in registers."""
    return tuple(g for g in (1, 2, 4, 8, 16, 32)
                 if g == 32 or -(-m // g) <= REG_ROWS[-1])


def ostat_plan(nb: int, m: int, p: int, sms: int = H100_SMS,
               threads_per_sm: int = H100_THREADS_PER_SM,
               lanes: int = None) -> OstatPlan:
    """The launch plan at ``(nb, m, p)`` on a card with ``sms`` SMs of
    ``threads_per_sm`` resident threads, with ``lanes`` lanes per
    coordinate where it is given (one of :func:`lane_counts`).

    Lanes per coordinate: the fewest that keep a lane's rows in registers
    (at most 8 each). Where that takes more than one lane, the group's sum
    is a chain of shuffles, but for a full warp it is one ``redux.sync``
    instruction, so a warp takes each coordinate wherever the card has
    the threads for it (``tools/kernel_compare.py --lanes`` times every
    lane count beside this choice)."""
    if lanes is None:
        lanes = 1
        while lanes < 32 and -(-m // lanes) > REG_ROWS[-1]:
            lanes *= 2
        if lanes > 1 and nb * p * 32 <= sms * threads_per_sm:
            lanes = 32
    elif lanes not in lane_counts(m):
        raise ValueError(f"lanes={lanes} at m={m}: one of {lane_counts(m)}")
    rows = -(-m // lanes)
    reg_rows = next((r for r in REG_ROWS if r >= rows), 0)
    slab = reg_rows == 0 and (BLOCK // lanes) * m * 4 <= MAX_SMEM
    return OstatPlan(lanes, reg_rows, slab)


@functools.lru_cache(maxsize=None)
def _card(index: int):
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.ostat_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("ostat", SOURCE, BUILD_DIR, _bind)


def library_path() -> Path:
    """The shared library built from the current source and flags."""
    return LIBRARY.library_path()


def build() -> ctypes.CDLL:
    """Compile ``csrc/ostat.cu`` with nvcc into :data:`BUILD_DIR` (once per
    source version; the compiler's output goes beside it as ``.log``) and
    load it. Raises if nvcc is missing or fails."""
    return LIBRARY.build()


def ostat(values: torch.Tensor, op: str, scale=None, *, K: int = 10,
          trim_beta: float = 0.2, kth: int = 0, n_bisect: int = N_BISECT,
          lanes: int = None):
    """Batched order-statistics aggregation ``(*B, m, p) -> (*B, p)``.

    The machine axis is second to last; leading axes are batch and ride
    the kernel's grid, so a whole stack of replicates is one launch.
    ``op="median_mad_dcq"`` returns the ``(median, mad, dcq)`` triple;
    every other op one tensor, in the input's dtype (computed in f32).
    ``scale`` (broadcastable to ``(*B, p)``) is required for ``op="dcq"``.

    ``lanes`` (one of :func:`lane_counts`) sets the lanes per coordinate
    in place of :func:`ostat_plan`'s choice; it lays the launch out and
    leaves the result as it is, up to summation order.

    A CUDA tensor goes through the CUDA kernel; a CPU tensor through
    :func:`ostat_plain`; a meta tensor (a dry-run trace, which computes
    nothing) through :func:`ostat_trace`, after the wrapper's own f32
    widening; anything else raises.
    """
    global launches
    g = _check(values, op, scale, K, trim_beta, kth, n_bisect, lanes)
    if values.device.type == "cpu":
        return ostat_plain(values, op, scale, K=K, trim_beta=trim_beta,
                           kth=kth, n_bisect=n_bisect, lanes=lanes)
    if values.device.type not in ("cuda", "meta"):
        raise ValueError(f"ostat runs on CUDA or CPU tensors, got "
                         f"{values.device}")
    batch = values.shape[:-2]
    m, p = values.shape[-2:]
    n_out = 3 if op == "median_mad_dcq" else 1
    vals, sc = _flat(values, scale, op)
    nb = vals.shape[0]
    if values.device.type == "meta":
        outs = ostat_trace(vals, n_out)
    else:
        outs = [torch.empty((nb, p), dtype=torch.float32,
                            device=values.device) for _ in range(n_out)]
    if nb and p and values.device.type == "cuda":
        knots, psi_sum = cq_constants(K)
        delta = (ctypes.c_float * max(K, 1))(*knots)
        mk = (ctypes.c_float * max(K, 1))(
            *[m * ((j + 1.0) / (K + 1.0)) for j in range(K)])
        ptrs = [o.data_ptr() for o in outs] + [None] * (3 - n_out)
        lib = build()
        with torch.cuda.device(values.device):
            plan = ostat_plan(nb, m, p, *_card(torch.cuda.current_device()),
                              lanes=lanes)
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.ostat_launch(
                vals.data_ptr(), None if sc is None else sc.data_ptr(),
                *ptrs, nb, m, p, OPS.index(op), kth, g, n_bisect, K,
                delta, mk, m * psi_sum, plan.lanes, plan.reg_rows,
                int(plan.slab), stream)
        if rc != 0:
            raise RuntimeError(f"ostat kernel launch failed for op={op!r} "
                               f"at (B={nb}, m={m}, p={p}): CUDA error {rc}")
        launches += 1
    res = tuple(o.reshape(batch + (p,)).to(values.dtype) for o in outs)
    return res if n_out > 1 else res[0]
