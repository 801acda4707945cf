"""GQA flash-decode: the CUDA kernel's wrapper and its plain PyTorch version —
counterpart of ``repro/kernels/gqa_decode.py`` (the Pallas kernel),
``gqa_decode_ref.py`` (its oracle) and ``kernels/ops.py decode_attention``.

One query token per sequence against a KV cache: q ``(B, Hq, Dh)``, k and v
``(B, S, Hkv, Dh)``, ``cache_len (B,)`` int32, out ``(B, Hq, Dh)`` in q's
dtype; the g = Hq / Hkv query heads of a kv head share its K/V rows, slots
at or past ``cache_len[b]`` do not count, and everything is accumulated in
f32 with scale ``1/sqrt(Dh)``.

* :func:`gqa_decode` is the wrapper. On a CUDA tensor it launches the kernel
  (``csrc/gqa_decode.cu``, built with ``nvcc`` at first use) or raises; it
  never falls back. On a CPU tensor it runs :func:`gqa_decode_plain`.
* :func:`gqa_decode_plain` is ``gqa_decode_reference`` in eager PyTorch,
  returned in q's dtype.
* :func:`split_plan` sizes the kernel's grid to the card: how many chunks
  each sequence's cache is split into, from the SM count and the kernel's
  resident blocks per SM, so that the blocks fill one wave.
* ``launches`` counts the kernel launches made through :func:`gqa_decode`
  (the kernel's two passes count as one).

At ``cache_len <= 0`` the two differ: no slot counts, and the kernel
returns zeros, while the plain version, like the JAX reference, averages V
over all S slots (the Pallas kernel averages over its padded S). Callers
pass ``cache_len >= 1``; the model passes ``min(pos + 1, Smax)``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.cuda_build import CudaLibrary

#: the reference's mask value
NEG_INF = -1e30
#: head dims and the largest query group (Hq / Hkv) the kernel takes (112
#: is zamba2-7b's 3584 / 32, read as two 64-dim TMA boxes a row)
HEAD_DIMS = (64, 112, 128)
MAX_GROUP = 16
#: chunks are multiples of MIN_CHUNK slots: one 16-slot tile for each of a
#: block's 4 warps (csrc/gqa_decode.cu takes multiples of 64)
MIN_CHUNK = 64

#: kernel launches made through :func:`gqa_decode` in this process.
launches = 0

SOURCE = Path(__file__).resolve().parent / "csrc" / "gqa_decode.cu"
#: where the shared library is built at first use (listed in .gitignore).
BUILD_DIR = Path(__file__).resolve().parent / "_build"

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softmax_scale(dh: int) -> float:
    """``1/sqrt(Dh)`` as the reference computes it (a Python float, which
    meets an f32 array and is rounded to f32 there)."""
    return 1.0 / (dh ** 0.5)


def gqa_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """``gqa_decode_reference`` in eager PyTorch: upcast to f32, scores,
    −1e30 mask past ``cache_len``, softmax, PV; returned in q's dtype."""
    B, Hq, Dh = q.shape
    _, S, Hkv, _ = k.shape
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, Dh).to(torch.float32)
    s = torch.einsum("bhgd,bthd->bhgt", qg, k.to(torch.float32)) \
        * softmax_scale(Dh)
    valid = torch.arange(S, device=q.device)[None] < cache_len[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bthd->bhgd", p, v.to(torch.float32))
    return out.reshape(B, Hq, Dh).to(q.dtype)


def _check(q, k, v, cache_len) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("cache_len", cache_len)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q (B, Hq, Dh) and k, v (B, S, Hkv, Dh); got "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Hq, Dh = q.shape
    Bk, S, Hkv, Dk = k.shape
    if Bk != B or Dk != Dh or S < 1 or B < 1 or Hkv < 1:
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k.shape)}")
    if Hq % Hkv:
        raise ValueError(f"Hq = {Hq} is not a multiple of Hkv = {Hkv}")
    if cache_len.shape != (B,) or cache_len.dtype != torch.int32:
        raise ValueError(f"need cache_len (B,) = ({B},) int32, got "
                         f"{tuple(cache_len.shape)} {cache_len.dtype}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or all bfloat16; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v, cache_len)}
    if len(devices) != 1:
        raise ValueError(f"q, k, v and cache_len on several devices: "
                         f"{sorted(map(str, devices))}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes Dh in {HEAD_DIMS}, got {Dh}")
    if Hq // Hkv > MAX_GROUP:
        raise ValueError(f"the kernel takes Hq / Hkv <= {MAX_GROUP}, got "
                         f"{Hq // Hkv}")
    for name, t in (("q", q), ("k", k), ("v", v), ("cache_len", cache_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "cache_len" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The split pass's grid: ``blocks`` = B * Hkv * ``n_chunks`` blocks,
    each taking one kv head of one sequence and one of the ``n_chunks``
    chunks its cache_len is split into on the card (``chunk`` slots at a
    full cache), on ``slots`` resident block slots (SMs x blocks per SM)
    in ``waves`` waves."""
    chunk: int
    n_chunks: int
    blocks: int
    slots: int
    waves: int


def chunk_for(length: int, n_chunks: int) -> int:
    """The slots each block takes of a sequence of ``length`` cached slots
    split into at most ``n_chunks`` chunks: ceil(length / n_chunks) rounded
    up to MIN_CHUNK (``chunk_for`` in csrc/gqa_decode.cu, which the kernel
    computes on the card from cache_len)."""
    return -(-(-(-length // n_chunks)) // MIN_CHUNK) * MIN_CHUNK


def split_plan(B: int, S: int, Hkv: int, sms: int,
               resident: int) -> SplitPlan:
    """The plan at ``(B, S, Hkv)`` on ``sms`` SMs holding ``resident``
    blocks each: as many chunks per (sequence, kv head) as one wave of
    block slots holds (at least one). The kernel splits each sequence's
    cache_len into that many chunks, each the smallest multiple of
    MIN_CHUNK slots that covers it, so a short cache spreads over the same
    blocks as a full one; ``chunk`` and ``n_chunks`` are those of a full
    cache (S slots). The blocks fit one wave whenever the (sequence, kv
    head) pairs do."""
    if min(B, S, Hkv, sms, resident) < 1:
        raise ValueError(f"no split plan for B={B}, S={S}, Hkv={Hkv} on "
                         f"{sms} SMs x {resident} blocks")
    slots = sms * resident
    pairs = B * Hkv
    chunk = chunk_for(S, max(1, slots // pairs))
    n_chunks = -(-S // chunk)
    blocks = pairs * n_chunks
    return SplitPlan(chunk, n_chunks, blocks, slots, -(-blocks // slots))


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.gqa_decode_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.gqa_decode_occupancy
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int


LIBRARY = CudaLibrary("gqa_decode", SOURCE, BUILD_DIR, _bind)


def library_path() -> Path:
    """The shared library built from the current source and flags."""
    return LIBRARY.library_path()


def build() -> ctypes.CDLL:
    """Compile ``csrc/gqa_decode.cu`` with nvcc into :data:`BUILD_DIR` (once
    per source version; the compiler's output goes beside it as ``.log``)
    and load it. Raises if nvcc is missing or fails."""
    return LIBRARY.build()


@functools.lru_cache(maxsize=None)
def card_plan(device: int, g: int, Dh: int, dtype: int) -> tuple:
    """(SMs, resident split-pass blocks per SM) of a card, from its
    properties and the occupancy calculator."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = build().gqa_decode_occupancy(g, Dh, dtype, ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"gqa_decode occupancy query failed (g={g}, "
                           f"Dh={Dh}): CUDA error {rc}, {blocks.value} "
                           f"blocks per SM")
    return (torch.cuda.get_device_properties(device).multi_processor_count,
            blocks.value)


def plan_for(q: torch.Tensor, k: torch.Tensor) -> SplitPlan:
    """The plan :func:`gqa_decode` launches for these CUDA tensors."""
    B, Hq, Dh = q.shape
    _, S, Hkv, _ = k.shape
    device = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    sms, resident = card_plan(device, Hq // Hkv, Dh, _DTYPES[q.dtype])
    return split_plan(B, S, Hkv, sms, resident)


@torch.library.custom_op("repro_torch::gqa_decode", mutates_args=())
def gqa_decode_trace(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """B2's launch as one op of a meta-device trace (the dry run's counting
    mode prices it by its bound: q, K and V over the cache's slots, and
    the output). It has only the meta rule: a tensor with data never
    reaches it."""
    raise RuntimeError("gqa_decode_trace is a meta-device trace op: the "
                       "kernel launches through gqa_decode")


@gqa_decode_trace.register_fake
def _gqa_decode_trace_meta(q, k, v, cache_len):
    return torch.empty_like(q)


def gqa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cache_len: torch.Tensor) -> torch.Tensor:
    """GQA flash-decode, q ``(B, Hq, Dh)`` against the cache k, v
    ``(B, S, Hkv, Dh)`` with ``cache_len (B,)`` int32 valid slots; returns
    ``(B, Hq, Dh)`` in q's dtype.

    It takes float32 or bfloat16 (q, k and v alike), Dh in
    :data:`HEAD_DIMS`, Hq / Hkv <= :data:`MAX_GROUP`, and contiguous
    16-byte-aligned tensors on one device, and raises on anything else.
    CUDA tensors go through the CUDA kernel, launched on the current
    stream; CPU tensors through :func:`gqa_decode_plain`; meta tensors (a
    dry-run trace, which computes nothing) through
    :func:`gqa_decode_trace`.
    """
    global launches
    _check(q, k, v, cache_len)
    if q.device.type == "cpu":
        return gqa_decode_plain(q, k, v, cache_len)
    if q.device.type == "meta":
        return gqa_decode_trace(q, k, v, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"gqa_decode runs on CUDA or CPU tensors, got "
                         f"{q.device}")
    B, Hq, Dh = q.shape
    _, S, Hkv, _ = k.shape
    g = Hq // Hkv
    lib = build()
    plan = plan_for(q, k)
    out = torch.empty_like(q)
    part_m = torch.empty((B, Hkv, plan.n_chunks, g), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B, Hkv, plan.n_chunks, g, Dh),
                           dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gqa_decode_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cache_len.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), B, S, Hkv, g, Dh, plan.n_chunks,
            _DTYPES[q.dtype], softmax_scale(Dh), stream)
    if rc != 0:
        raise RuntimeError(f"gqa_decode kernel launch failed at (B={B}, "
                           f"Hq={Hq}, Hkv={Hkv}, Dh={Dh}, S={S}, "
                           f"{q.dtype}): CUDA error {rc}")
    launches += 1
    return out
