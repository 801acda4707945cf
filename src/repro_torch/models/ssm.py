"""Mamba2 (SSD) layer, zamba2's backbone mixer — ``repro/models/ssm.py``
counterpart. [arXiv:2405.21060 form]

The chunked "state-space dual" form: attention-like matmuls within each
chunk and a recurrence over chunks (a Python loop; the reference's
``lax.scan``). Decode is the O(1) recurrent update. Grouped B/C
(n_groups) as in Mamba2, a D skip and a causal depthwise conv in front.

Shapes: x (B, S, d_model); d_inner = expand * d_model; H = d_inner /
headdim heads; state size N = d_state. ``p`` is one layer's mixer
(``w_in``, ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``,
``w_out``), reached by attribute; ``a_log``, ``dt_bias`` and ``d_skip`` are
float32 in any model dtype, and so is the decode cache.

Zamba2 as published (a ``configs.base.Zamba2Config``) adds a ``norm``
leaf (d_inner,): the scan's output gated by ``SiLU(z)`` is RMS
normalised in ``n_groups`` groups before ``w_out``; and it floors the
step at ``dt_min``. Any other config runs the mixer as before.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig, Zamba2Config
from repro_torch.models.layers import _init


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.headdim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, H, conv_dim


def ssm_init(cfg: ModelConfig, *, generator=None, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
    """The fused input projection ``w_in`` (d, [z | x+B+C | dt]),
    ``conv_w`` (d_conv, conv_dim), ``conv_b`` (zeros), ``a_log``,
    ``dt_bias``, ``d_skip`` (H,) in f32, the gated norm's ``norm``
    (d_inner,) of ones where the config has one, and ``w_out`` (d_inner,
    d); the random leaves drawn in the order ``w_in``, ``conv_w``,
    ``w_out``."""
    s = cfg.ssm
    d_inner, H, conv_dim = _dims(cfg)
    kw = dict(generator=generator, dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    p = {"w_in": _init((cfg.d_model, d_inner + conv_dim + H), **kw),
         "conv_w": _init((s.d_conv, conv_dim), scale=0.5, **kw),
         "conv_b": torch.zeros(conv_dim, dtype=dtype, device=device),
         "a_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
         "dt_bias": torch.zeros(H, **f32),
         "d_skip": torch.ones(H, **f32)}
    if isinstance(cfg, Zamba2Config):
        p["norm"] = torch.ones(d_inner, dtype=dtype, device=device)
    p["w_out"] = _init((d_inner, cfg.d_model), **kw)
    return p


def _split_proj(p, x: torch.Tensor, cfg: ModelConfig):
    d_inner, H, conv_dim = _dims(cfg)
    proj = x @ p.w_in
    return (proj[..., :d_inner], proj[..., d_inner:d_inner + conv_dim],
            proj[..., d_inner + conv_dim:])                 # z, xbc, dt


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    s = cfg.ssm
    d_inner, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    return (xbc[..., :d_inner], xbc[..., d_inner:d_inner + gn],
            xbc[..., d_inner + gn:])                        # x, B, C


def _conv_train(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                d_conv: int) -> torch.Tensor:
    """Causal depthwise conv over S, then SiLU. xbc: (B, S, C)."""
    S = xbc.shape[1]
    pads = F.pad(xbc, (0, 0, d_conv - 1, 0))
    out = pads[:, 0:S] * w[0]
    for i in range(1, d_conv):
        out = out + pads[:, i:i + S] * w[i]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                Bmat: torch.Tensor, Cmat: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """SSD scan. x: (B, S, H, dh); dt: (B, S, H); Bmat/Cmat: (B, S, G, N)."""
    Bsz, S, H, dh = x.shape
    G, N = Bmat.shape[2], Bmat.shape[3]
    Q = min(cfg.ssm.chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bmat = F.pad(Bmat, (0, 0, 0, 0, 0, pad))
        Cmat = F.pad(Cmat, (0, 0, 0, 0, 0, pad))
    Sp = x.shape[1]
    nc = Sp // Q
    rep = H // G                                   # heads per group

    A = -torch.exp(a_log)                          # (H,), negative
    dta = dt * A                                   # (B,Sp,H) log-decay
    xdt = x * dt[..., None]                        # dt-weighted input

    def c(t):                                      # chunk the time axis
        return t.reshape((Bsz, nc, Q) + tuple(t.shape[2:]))

    xc, dtac = c(xdt), c(dta)
    Bc = c(Bmat).repeat_interleave(rep, dim=3)     # (B,nc,Q,H,N)
    Cc = c(Cmat).repeat_interleave(rep, dim=3)
    la = torch.cumsum(dtac, dim=2)                 # (B,nc,Q,H) cum log decay

    # within a chunk: L[i, j] = exp(la_i - la_j) for j <= i. The mask goes
    # on BEFORE exp: a masked entry has la_i - la_j > 0, and exp of a large
    # one is inf, whose product with a zero gradient is NaN in backward.
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]       # (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    seg = torch.where(causal[None, None, :, :, None], seg, -torch.inf)
    L = torch.exp(seg)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc, Bc) * L
    y_intra = torch.einsum("bcqkh,bckhd->bcqhd", scores, xc)

    # chunk-final states: sum_j exp(la_Q - la_j) B_j (x_j dt_j)^T
    decay_to_end = torch.exp(la[:, :, -1:, :] - la)         # (B,nc,Q,H)
    states = torch.einsum("bcqhn,bcqhd->bchnd",
                          decay_to_end[..., None] * Bc, xc)  # (B,nc,H,N,dh)

    # the recurrence over chunks: the state entering each chunk
    chunk_decay = torch.exp(la[:, :, -1, :])                # (B,nc,H)
    prev = torch.zeros((Bsz, H, N, dh), dtype=x.dtype, device=x.device)
    prevs = []
    for i in range(nc):
        prevs.append(prev)
        prev = prev * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prevs, dim=1)                 # (B,nc,H,N,dh)

    y_inter = torch.einsum("bcqhn,bchnd->bcqhd",
                           torch.exp(la)[..., None] * Cc, prev_states)
    y = (y_intra + y_inter).reshape(Bsz, Sp, H, dh)
    return y[:, :S]


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. x: (B, S, d_model)."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    B_, S, _ = x.shape
    z, xbc, dt = _split_proj(p, x, cfg)
    xbc = _conv_train(xbc, p.conv_w, p.conv_b, s.d_conv)
    xs, Bmat, Cmat = _split_xbc(xbc, cfg)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    published = isinstance(cfg, Zamba2Config)
    if published:
        dt = dt.clamp_min(cfg.dt_min)
    xh = xs.reshape(B_, S, H, s.headdim).to(torch.float32)
    Bm = Bmat.reshape(B_, S, s.n_groups, s.d_state).to(torch.float32)
    Cm = Cmat.reshape(B_, S, s.n_groups, s.d_state).to(torch.float32)
    y = ssd_chunked(xh, dt, p.a_log, Bm, Cm, cfg)
    y = y + xh * p.d_skip[None, None, :, None]
    y = y.reshape(B_, S, d_inner) * F.silu(z.to(torch.float32))
    if published:
        y = _group_rms(y, p.norm, s.n_groups, cfg.norm_eps)
    return y.to(x.dtype) @ p.w_out


def _group_rms(y: torch.Tensor, w: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    """RMS norm of f32 ``y`` (..., d_inner) over each of ``groups`` equal
    groups of its last axis, times ``w``."""
    g = y.unflatten(-1, (groups, -1))
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return g.flatten(-2) * w.to(torch.float32)


# ---------------------------------------------------------------- decode

def ssm_cache_init(cfg: ModelConfig, batch: int,
                   device=None) -> Dict[str, torch.Tensor]:
    """``state`` (B, H, N, headdim) and ``conv`` (B, d_conv - 1,
    conv_dim), f32 zeros."""
    s = cfg.ssm
    _, H, conv_dim = _dims(cfg)
    kw = dict(dtype=torch.float32, device=device)
    return {"state": torch.zeros((batch, H, s.d_state, s.headdim), **kw),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), **kw)}


def ssm_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent update. x: (B, 1, d_model). Returns the output
    and a new cache; the conv window and the state are f32 (the
    reference's promotion of the model-dtype projection against its f32
    cache)."""
    s = cfg.ssm
    d_inner, H, _ = _dims(cfg)
    B_ = x.shape[0]
    z, xbc, dt = _split_proj(p, x, cfg)                     # (B,1,*)
    hist = torch.cat([cache["conv"], xbc.to(torch.float32)], dim=1)
    conv_out = F.silu((hist * p.conv_w.to(torch.float32)).sum(dim=1)
                      + p.conv_b.to(torch.float32))[:, None]
    xs, Bmat, Cmat = _split_xbc(conv_out, cfg)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)[:, 0]    # (B,H)
    xh = xs.reshape(B_, H, s.headdim)
    rep = H // s.n_groups
    Bm = Bmat.reshape(B_, s.n_groups, s.d_state).repeat_interleave(rep, 1)
    Cm = Cmat.reshape(B_, s.n_groups, s.d_state).repeat_interleave(rep, 1)
    decay = torch.exp(dt * -torch.exp(p.a_log))             # (B,H)
    upd = (dt[..., None] * Bm)[..., :, None] * xh[..., None, :]
    state = cache["state"] * decay[..., None, None] + upd   # (B,H,N,dh)
    y = torch.einsum("bhn,bhnd->bhd", Cm, state)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(B_, 1, d_inner) * F.silu(z.to(torch.float32))
    out = y.to(x.dtype) @ p.w_out
    return out, {"state": state, "conv": hist[:, 1:]}


def ssm_reference(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential-scan oracle for :func:`ssd_chunked` (tests only)."""
    cache = ssm_cache_init(cfg, x.shape[0], x.device)
    outs = []
    for t in range(x.shape[1]):
        o, cache = ssm_decode(p, x[:, t:t + 1], cache, cfg)
        outs.append(o)
    return torch.cat(outs, dim=1)
