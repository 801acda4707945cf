"""Zamba2 as published, plain, for the tests of the port's
``Zamba2Config`` model: torch operations in the parameters' dtype,
written from the layer equations (``transformers``' ``Zamba2HybridLayer``,
``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``, ``Zamba2MambaDecoderLayer``
and ``Zamba2MambaMixer.torch_forward``), with no kernel or module of
``repro_torch``.

Parameters are ``{path: tensor}`` under the port's leaf paths. With e the
token embedding and h = e:

* Mamba2 layer i: ``h + M_i(rms(h + t))``, t the insertion's output where
  layer i is a hybrid layer, else 0;
* insertion j (block b = j mod num_mem_blocks): ``x = rms([h ‖ e])``,
  causal attention of x with rotary embedding (``rotate_half`` over the
  whole head) at scale ``(head_dim / 2) ** -0.5``, ``u = rms(attn)``,
  ``[g ‖ v] = u W_gu + (u A_j) B_j``, ``t = ((gelu(g) * v) W_down) L_j``;
* mixer M: ``[z ‖ xBC ‖ dt] = x W_in``; a causal depthwise conv of
  width ``d_conv`` plus bias, SiLU; x, B, C; ``dt = max(softplus(dt +
  dt_bias), dt_min)``; the SSD recurrence with ``A = -exp(a_log)`` (head
  h reads group ``h // (H / G)``), plus ``D x``; the gated group RMS norm
  ``w * grouprms(y * silu(z))``; ``W_out``;
* head: ``rms(h) E^T``; the mean next-token cross entropy.

The scan is :func:`ssd_minimal`, the chunked form of the Mamba2 paper's
listing (segment sums over each chunk, then over the chunks), held to the
step-by-step :func:`ssd_sequential` by the tests.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.nn import functional as F


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, dh): ``x cos + rotate_half(x) sin``, the frequencies
    repeated over the two halves of the head."""
    S, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float64) / dh)
    ang = torch.arange(S, dtype=torch.float64)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    cos = emb.cos().to(x.dtype)[None, :, None]
    sin = emb.sin().to(x.dtype)[None, :, None]
    half = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], dim=-1)
    return x * cos + half * sin


def ssd_sequential(x, dt, A, B, C):
    """The recurrence step by step. x (b, l, h, p), dt (b, l, h), A (h,),
    B and C (b, l, h, n) (already one per head): ``s_t = exp(dt_t A)
    s_{t-1} + dt_t x_t B_t^T``, ``y_t = s_t C_t``."""
    b, l, h, p = x.shape
    s = torch.zeros(b, h, p, B.shape[-1], dtype=x.dtype)
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * A)[..., None, None]
        s = s * decay + (dt[:, t, :, None] * x[:, t])[..., None] \
            * B[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", s, C[:, t]))
    return torch.stack(ys, dim=1)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): entry [i, j] the sum of a over (j, i],
    -inf above the diagonal."""
    T = a.shape[-1]
    a = a[..., None].expand(*a.shape, T)
    a = a.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool), -1),
                      0)
    out = torch.cumsum(a, dim=-2)
    return out.masked_fill(~torch.tril(torch.ones(T, T, dtype=torch.bool)),
                           -torch.inf)


def ssd_minimal(x, dt, A, B, C, chunk: int):
    """The chunked SSD of the Mamba2 paper's minimal listing, over the
    same arguments as :func:`ssd_sequential` (the sequence padded to a
    whole number of chunks)."""
    b, l, h, p = x.shape
    pad = (-l) % chunk
    X = F.pad(x * dt[..., None], (0, 0, 0, 0, 0, pad))
    Ad = F.pad(dt * A, (0, 0, 0, pad))
    Bp = F.pad(B, (0, 0, 0, 0, 0, pad))
    Cp = F.pad(C, (0, 0, 0, 0, 0, pad))
    c = (l + pad) // chunk
    X, Bp, Cp = (t.reshape(b, c, chunk, *t.shape[2:]) for t in (X, Bp, Cp))
    Ad = Ad.reshape(b, c, chunk, h).permute(0, 3, 1, 2)      # b h c l
    cum = torch.cumsum(Ad, dim=-1)
    L = torch.exp(segsum(Ad))
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cp, Bp, L, X)
    decay = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bp, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", Cp, states,
                         torch.exp(cum))
    return (y_diag + y_off).reshape(b, c * chunk, h, p)[:, :l]


def mixer(P: Dict[str, torch.Tensor], i: int, x: torch.Tensor, cfg):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H, G, N = d_inner // s.headdim, s.n_groups, s.d_state
    W = {k: P[f"layers/ssm/{k}"][i] for k in
         ("w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm",
          "w_out")}
    b, l, _ = x.shape
    z, xbc, dt = (x @ W["w_in"]).split([d_inner, d_inner + 2 * G * N, H],
                                       dim=-1)
    C_ = xbc.shape[-1]
    xbc = F.conv1d(xbc.transpose(1, 2), W["conv_w"].T[:, None, :],
                   W["conv_b"], padding=s.d_conv - 1, groups=C_)[..., :l]
    xbc = F.silu(xbc.transpose(1, 2))
    xs, Bm, Cm = xbc.split([d_inner, G * N, G * N], dim=-1)
    dt = F.softplus(dt + W["dt_bias"]).clamp_min(cfg.dt_min)
    A = -torch.exp(W["a_log"])
    xs = xs.reshape(b, l, H, s.headdim)
    Bm = Bm.reshape(b, l, G, N).repeat_interleave(H // G, dim=2)
    Cm = Cm.reshape(b, l, G, N).repeat_interleave(H // G, dim=2)
    y = ssd_minimal(xs, dt, A, Bm, Cm, s.chunk)
    y = (y + W["d_skip"][:, None] * xs).reshape(b, l, d_inner)
    y = (y * F.silu(z)).reshape(b, l, G, d_inner // G)
    y = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
    return (y.reshape(b, l, d_inner) * W["norm"]) @ W["w_out"]


def shared(P, blk: int, j: int, h, e, cfg):
    W = {k.split("/", 1)[1]: v[blk] for k, v in P.items()
         if k.startswith("shared_blocks/")}
    eps = cfg.norm_eps
    x = rms(torch.cat([h, e], -1), W["norm1"], eps)
    b, l, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    q = rope((x @ W["attn/w_q"]).reshape(b, l, H, dh), cfg.rope_theta)
    k = rope((x @ W["attn/w_k"]).reshape(b, l, H, dh), cfg.rope_theta)
    v = (x @ W["attn/w_v"]).reshape(b, l, H, dh)
    sc = torch.einsum("bqhd,bkhd->bhqk", q, k) * (dh / 2) ** -0.5
    causal = torch.ones(l, l, dtype=torch.bool).tril()
    pr = torch.softmax(sc.masked_fill(~causal, -torch.inf), dim=-1)
    a = torch.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, l, H * dh)
    u = rms(a @ W["attn/w_o"], W["norm2"], eps)
    gu = u @ W["mlp/w_gate_up"] + (u @ P["insertions/adapter_a"][j]) \
        @ P["insertions/adapter_b"][j]
    g, up = gu.chunk(2, dim=-1)
    return ((F.gelu(g) * up) @ W["mlp/w_down"]) @ P["insertions/linear"][j]


def loss(P: Dict[str, torch.Tensor], tokens: torch.Tensor,
         labels: torch.Tensor, cfg) -> torch.Tensor:
    """The mean next-token cross entropy of ``tokens`` (B, S) against
    ``labels``."""
    e = P["embed"][tokens]
    h, j = e, 0
    for i in range(cfg.n_layers):
        t = 0
        if i in cfg.hybrid_layers:
            t = shared(P, j % cfg.num_mem_blocks, j, h, e, cfg)
            j += 1
        h = h + mixer(P, i, rms(h + t, P["layers/norm"][i], cfg.norm_eps),
                      cfg)
    logits = rms(h, P["norm_f"], cfg.norm_eps) @ P["embed"].T
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def n_params(cfg) -> int:
    """The published count of ``cfg``'s parameters, by its equations."""
    d, f, r, V = cfg.d_model, cfg.d_ff, cfg.adapter_rank, cfg.vocab
    s = cfg.ssm
    di = s.expand * d
    H = di // s.headdim
    conv = di + 2 * s.n_groups * s.d_state
    mamba = d * (2 * di + 2 * s.n_groups * s.d_state + H) + conv * \
        (s.d_conv + 1) + 3 * H + di + di * d + d
    hq = cfg.n_heads * cfg.head_dim
    block = 2 * d * (1 + 3 * hq) + hq * d + d + d * 2 * f + f * d
    ins = len(cfg.hybrid_layers) * (d * r + r * 2 * f + d * d)
    return cfg.n_layers * mamba + cfg.num_mem_blocks * block + ins \
        + V * d + d

