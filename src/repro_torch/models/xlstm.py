"""xLSTM blocks: mLSTM (matrix memory, chunked parallel form) and sLSTM
(scalar memory, recurrent scan) — ``repro/models/xlstm.py`` counterpart.
[arXiv:2405.04517]

mLSTM uses the stabilised parallel form. The decay is separable,
D~[i, j] = F_i + (itilde_j - F_j) with F the cumulative log-forget, so it
streams like flash attention: query chunks against KV chunks with a
running max and a rescale, and no (S x S) matrix is live. The reference
scans every (query chunk, KV chunk) pair; a KV chunk after the query
chunk is fully masked and adds exactly nothing (its weights are
exp(-1e30 - m) = 0 and the running max does not move), so the loop here
stops at the diagonal. Decode is the O(1) matrix-memory recurrence with
the (C, n, m) stabiliser state.

sLSTM keeps per-head scalar memories with recurrent mixing and runs a
Python loop over time (sequential, as in the paper; the reference's
``lax.scan``). Its input projection is one matmul over the whole
sequence before the loop.

``p`` is one layer's mixer, reached by attribute (``blocks.tree_view``).
``w_if``/``b_if`` (mLSTM) and ``r_h``/``b`` (sLSTM) are float32 in any
model dtype, as are both decode caches.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _init

NEG_INF = -1e30


# ================================================================== mLSTM

def mlstm_init(cfg: ModelConfig, *, generator=None, dtype=torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """``w_up``/``w_gate`` (d, 2d), ``w_q``/``w_k``/``w_v`` (2d, 2d),
    ``w_if`` (2d, 2H) and ``b_if`` (2H,) in f32, ``w_down`` (2d, d),
    drawn in this order."""
    d, H = cfg.d_model, cfg.n_heads
    d_inner = 2 * d
    kw = dict(generator=generator, dtype=dtype, device=device)
    f32 = dict(kw, dtype=torch.float32)
    p = {"w_up": _init((d, d_inner), **kw),
         "w_gate": _init((d, d_inner), **kw),
         "w_q": _init((d_inner, d_inner), **kw),
         "w_k": _init((d_inner, d_inner), **kw),
         "w_v": _init((d_inner, d_inner), **kw),
         "w_if": _init((d_inner, 2 * H), scale=0.02, **f32)}
    p["b_if"] = torch.cat([torch.zeros(H, device=device),
                           torch.linspace(3.0, 6.0, H, device=device)])
    p["w_down"] = _init((d_inner, d), **kw)
    return p


def _mlstm_qkvif(p, x: torch.Tensor, cfg: ModelConfig):
    H = cfg.n_heads
    B, S, _ = x.shape
    d_inner = p.w_up.shape[1]
    dh = d_inner // H
    u = x @ p.w_up
    gate = F.silu(x @ p.w_gate)
    q = (u @ p.w_q).reshape(B, S, H, dh)
    k = (u @ p.w_k).reshape(B, S, H, dh)
    v = (u @ p.w_v).reshape(B, S, H, dh)
    gates = u.to(torch.float32) @ p.w_if + p.b_if
    return q, k, v, gates[..., :H], gates[..., H:], gate     # (B,S,H) gates


def mlstm_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  chunk: int = 512) -> torch.Tensor:
    """Chunked-parallel stabilised mLSTM. x: (B, S, d_model). The decay
    exponents, the running max and the sums are f32."""
    B, S, _ = x.shape
    H = cfg.n_heads
    d_inner = p.w_up.shape[1]
    dh = d_inner // H
    q, k, v, itilde, ftilde, gate = _mlstm_qkvif(p, x, cfg)
    logf = F.logsigmoid(ftilde)                               # (B,S,H)
    Fc = torch.cumsum(logf, dim=1)                            # cumulative
    a = Fc                                                    # query weight
    b = itilde - Fc                                           # key weight

    Q = min(chunk, S)     # the reference's dry-run chunk override is off
    pad = (-S) % Q
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        a = F.pad(a, (0, 0, 0, pad), value=0.0)
        b = F.pad(b, (0, 0, 0, pad), value=NEG_INF)
    nc = q.shape[1] // Q
    pos = torch.arange(nc * Q, device=x.device).reshape(nc, Q)
    scale = 1.0 / (dh ** 0.5)

    hs = []
    for i in range(nc):
        rows = slice(i * Q, (i + 1) * Q)
        q_i, a_i = q[:, rows], a[:, rows]                     # (B,Q,H,dh)
        num = torch.zeros((B, Q, H, dh), dtype=torch.float32,
                          device=x.device)
        den = torch.zeros((B, Q, H), dtype=torch.float32, device=x.device)
        m = torch.full((B, Q, H), NEG_INF, dtype=torch.float32,
                       device=x.device)
        for j in range(i + 1):        # KV chunks past i are fully masked
            cols = slice(j * Q, (j + 1) * Q)
            k_j, v_j, b_j = k[:, cols], v[:, cols], b[:, cols]
            dmat = a_i[:, :, None, :] + b_j[:, None, :, :]    # (B,Q,Q,H)
            causal = pos[j][None, :] <= pos[i][:, None]       # (Q,Q)
            dmat = torch.where(causal[None, :, :, None], dmat, NEG_INF)
            m_new = torch.maximum(m, dmat.amax(dim=2))        # (B,Q,H)
            w = torch.exp(dmat - m_new[:, :, None, :])
            qk = torch.einsum("bqhd,bkhd->bqkh", q_i, k_j) \
                .to(torch.float32) * scale
            s = qk * w
            corr = torch.exp(m - m_new)
            num = num * corr[..., None] + torch.einsum(
                "bqkh,bkhd->bqhd", s, v_j.to(torch.float32))
            den = den * corr + s.sum(dim=2)
            m = m_new
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m))[..., None])
    h = torch.cat(hs, dim=1).reshape(B, nc * Q, d_inner)[:, :S]
    return (h.to(x.dtype) * gate) @ p.w_down


def mlstm_cache_init(cfg: ModelConfig, batch: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """``C`` (B, H, dh, dh), ``n`` (B, H, dh), ``m`` (B, H) at -1e30 and
    ``f_acc`` (B, H), all f32."""
    H = cfg.n_heads
    dh = 2 * cfg.d_model // H
    kw = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **kw),
            "n": torch.zeros((batch, H, dh), **kw),
            "m": torch.full((batch, H), NEG_INF, **kw),
            "f_acc": torch.zeros((batch, H), **kw)}


def mlstm_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrent mLSTM. x: (B, 1, d_model). Returns the output
    and a new cache."""
    B = x.shape[0]
    H = cfg.n_heads
    d_inner = p.w_up.shape[1]
    dh = d_inner // H
    q, k, v, itilde, ftilde, gate = _mlstm_qkvif(p, x, cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                       # (B,H,dh)
    itilde, ftilde = itilde[:, 0], ftilde[:, 0]               # (B,H)
    logf = F.logsigmoid(ftilde)
    m_prev, C_prev, n_prev = cache["m"], cache["C"], cache["n"]
    m_new = torch.maximum(logf + m_prev, itilde)
    fw = torch.exp(logf + m_prev - m_new)
    iw = torch.exp(itilde - m_new)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    C = fw[..., None, None] * C_prev + iw[..., None, None] * \
        (kf[..., :, None] * vf[..., None, :])
    n = fw[..., None] * n_prev + iw[..., None] * kf
    qf = q.to(torch.float32) * (1.0 / (dh ** 0.5))
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.maximum((qf * n).sum(-1).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(B, 1, d_inner)
    out = (h.to(x.dtype) * gate) @ p.w_down
    return out, {"C": C, "n": n, "m": m_new, "f_acc": cache["f_acc"] + logf}


# ================================================================== sLSTM

def slstm_init(cfg: ModelConfig, *, generator=None, dtype=torch.float32,
               device=None) -> Dict[str, torch.Tensor]:
    """``w_x`` (d, 4d) (z, i, f, o), the block-diagonal recurrent weights
    ``r_h`` (H, dh, 4 dh) and the bias ``b`` (4d,) in f32, ``w_down``
    (d, d), drawn in this order."""
    d, H = cfg.d_model, cfg.n_heads
    dh = d // H
    kw = dict(generator=generator, dtype=dtype, device=device)
    p = {"w_x": _init((d, 4 * d), **kw),
         "r_h": _init((H, dh, 4 * dh), scale=0.1,
                      **dict(kw, dtype=torch.float32))}
    p["b"] = torch.cat([torch.zeros(2 * d, device=device),
                        torch.ones(d, device=device),
                        torch.zeros(d, device=device)])
    p["w_down"] = _init((d, d), **kw)
    return p


def slstm_cache_init(cfg: ModelConfig, batch: int,
                     device=None) -> Dict[str, torch.Tensor]:
    """``c``, ``n`` (ones), ``h`` and ``m``, each (B, H, dh) f32."""
    H = cfg.n_heads
    shape = (batch, H, cfg.d_model // H)
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros(shape, **kw), "n": torch.ones(shape, **kw),
            "h": torch.zeros(shape, **kw), "m": torch.zeros(shape, **kw)}


def _slstm_cell(p, wxb: torch.Tensor, state: Dict[str, torch.Tensor],
                cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """One step from ``wxb`` (B, 4d) f32, the step's input projection
    ``x_t @ w_x`` (in the model's dtype) widened and plus ``b``."""
    H = cfg.n_heads
    dh = cfg.d_model // H
    B = wxb.shape[0]
    rh = torch.einsum("bhd,hde->bhe", state["h"], p.r_h)       # (B,H,4dh)
    pre = wxb.reshape(B, H, 4, dh) + rh.reshape(B, H, 4, dh)
    ztil, itil, ftil, otil = pre.unbind(dim=2)
    z = torch.tanh(ztil)
    o = torch.sigmoid(otil)
    lm = F.logsigmoid(ftil) + state["m"]          # log f + m, used twice
    m_new = torch.maximum(lm, itil)
    iw = torch.exp(itil - m_new)
    fw = torch.exp(lm - m_new)
    c = fw * state["c"] + iw * z
    n = fw * state["n"] + iw
    h = o * c / torch.clamp_min(n, 1e-6)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _wxb(p, x: torch.Tensor) -> torch.Tensor:
    return (x @ p.w_x).to(torch.float32) + p.b


def slstm_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential sLSTM over S. x: (B, S, d_model). The input projection
    of every step is one matmul before the loop; each step is then about
    twenty small device operations (the host's launch rate sets the
    time of a long sequence on the card)."""
    B, S, d = x.shape
    state = slstm_cache_init(cfg, B, x.device)
    wxb = _wxb(p, x)                                        # (B, S, 4d)
    hs = []
    for t in range(S):
        state = _slstm_cell(p, wxb[:, t], state, cfg)
        hs.append(state["h"])
    h = torch.stack(hs, dim=1).reshape(B, S, d)
    return h.to(x.dtype) @ p.w_down


def slstm_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token sLSTM step. x: (B, 1, d_model). Returns the output and a
    new cache."""
    st = _slstm_cell(p, _wxb(p, x[:, 0]), cache, cfg)
    h = st["h"].reshape(x.shape[0], 1, cfg.d_model)
    return h.to(x.dtype) @ p.w_down, st
