"""The plain glm4 dense model: its parameter leaves, its weights from a
seed, and one machine's loss and gradient in float32 with TF32 off.

Written from the layer equations, with no kernel, cache or batching of
the program: token embedding; per layer a pre-norm (RMS) causal GQA
attention with rotary position embedding over the two halves of each
head (theta 1e4), query head h reading kv head h // (Hq / Hkv), then a
pre-norm SwiGLU MLP, ``down(silu(x W_gate) * (x W_up))``; a final RMS
norm, the output head and the mean next-token cross entropy. Matrices
are ``(fan_in, fan_out)`` and applied as ``x @ W``. Every weight is held
in its storage dtype (bf16 for the configuration) and widened to float32
where it is used; each gradient is computed in float32 and rounded once
to the storage dtype, as a bf16 gradient is handed to the wire. The
embedding's gradient is summed over repeated tokens in float32.

``lowp="fp8"`` is the control: every matrix product takes its operands,
and its backward its incoming gradient, through a scaled fp8 rounding
(e4m3 forward, e5m2 backward, one scale per tensor at its absolute
maximum), the step below bf16 that would tempt a later change.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F

F32 = torch.float32
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def storage_dtype(cfg: Dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


def leaf_specs(cfg: Dict) -> List[Tuple[str, tuple, Optional[float]]]:
    """``(path, shape, init scale)`` of every leaf, in the wire's order
    (paths sorted); a scale of None is a norm weight of ones."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab"]
    dh = cfg["head_dim"]
    hq, hkv, f = cfg["n_heads"] * dh, cfg["n_kv_heads"] * dh, cfg["d_ff"]
    specs = [
        ("embed", (V, d), 0.02),
        ("layers/attn/w_k", (L, d, hkv), 1 / math.sqrt(d)),
        ("layers/attn/w_o", (L, hq, d), 1 / math.sqrt(hq)),
        ("layers/attn/w_q", (L, d, hq), 1 / math.sqrt(d)),
        ("layers/attn/w_v", (L, d, hkv), 1 / math.sqrt(d)),
        ("layers/mlp/w_down", (L, f, d), 1 / math.sqrt(f)),
        ("layers/mlp/w_gate", (L, d, f), 1 / math.sqrt(d)),
        ("layers/mlp/w_up", (L, d, f), 1 / math.sqrt(d)),
        ("layers/norm1", (L, d), None),
        ("layers/norm2", (L, d), None),
        ("lm_head", (d, V), 0.02),
        ("norm_f", (d,), None),
    ]
    return sorted(specs)


def make_params(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf's initial weights, as views of one flat buffer: standard
    normals drawn in the storage dtype in one call from the generator
    seeded with ``seed``, each leaf's span times its scale (norm weights
    are ones). The same call gives the same tensors, so the weights can be
    made again instead of kept."""
    specs = leaf_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, dtype=storage_dtype(cfg),
                       device=device)
    out = {}
    for (path, shape, scale), part in zip(specs, flat.split(sizes)):
        if scale is None:
            part.fill_(1)
        else:
            part.mul_(scale)
        out[path] = part.view(shape)
    return out


# ------------------------------------------------------------ the control

def _fp8_round(x: torch.Tensor, dtype) -> torch.Tensor:
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2).to(g.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, lowp: Optional[str]):
    if lowp == "fp8":
        a, b = _FP8.apply(a), _FP8.apply(b)
    return a @ b


# ------------------------------------------------------------ the model

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.to(F32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, dh): rotate the two halves of each head by position."""
    S, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=F32,
                                       device=x.device) / dh)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(x, wq, wk, wv, wo, cfg, lowp):
    B, S, _ = x.shape
    H, Hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = _rope(_mm(x, wq, lowp).reshape(B, S, H, dh), cfg["rope_theta"])
    k = _rope(_mm(x, wk, lowp).reshape(B, S, Hkv, dh), cfg["rope_theta"])
    v = _mm(x, wv, lowp).reshape(B, S, Hkv, dh)
    rep = H // Hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, S, dh)
    scores = _mm(q, k.transpose(-1, -2), lowp) / math.sqrt(dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = _mm(torch.softmax(scores, dim=-1), v, lowp)
    out = out.transpose(1, 2).reshape(B, S, H * dh)
    return _mm(out, wo, lowp)


def _forward_loss(h, W, labels, cfg, lowp, half=False):
    eps = cfg["norm_eps"]
    for i in range(cfg["n_layers"]):
        a = W["layers/attn"]
        h = h + _attention(_rms(h, W["layers/norm1"][i], eps),
                           a["w_q"][i].to(F32), a["w_k"][i].to(F32),
                           a["w_v"][i].to(F32), a["w_o"][i].to(F32),
                           cfg, lowp)
        x = _rms(h, W["layers/norm2"][i], eps)
        mlp = W["layers/mlp"]
        h = h + _mm(F.silu(_mm(x, mlp["w_gate"][i].to(F32), lowp))
                    * _mm(x, mlp["w_up"][i].to(F32), lowp),
                    mlp["w_down"][i].to(F32), lowp)
    h = _rms(h, W["norm_f"], eps)
    logits = _mm(h, W["lm_head"].to(F32), lowp)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = logz - gold
    return nll[:, :nll.shape[1] // 2].mean() if half else nll.mean()


def loss_and_grads(P: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   labels: torch.Tensor, cfg: Dict,
                   lowp: Optional[str] = None, half: bool = False
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One machine's mean next-token cross entropy over ``tokens`` (B, S)
    and ``labels`` (B, S) at the parameters ``P`` (path -> tensor), in
    float32 with TF32 off, and its gradient per leaf in the storage
    dtype. Returns ``(loss (float32 scalar), grads)``. ``half`` is a
    planted fault for the check's own test: the mean over the first half
    of the positions only."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = cfg["d_model"]
    names = [p for p, _, _ in leaf_specs(cfg) if p != "embed"]
    leaves = {p: P[p].detach().requires_grad_() for p in names}
    h0 = P["embed"].detach()[tokens].to(F32).requires_grad_()
    W = {"layers/attn": {k: leaves[f"layers/attn/{k}"]
                         for k in ("w_q", "w_k", "w_v", "w_o")},
         "layers/mlp": {k: leaves[f"layers/mlp/{k}"]
                        for k in ("w_gate", "w_up", "w_down")},
         "layers/norm1": leaves["layers/norm1"],
         "layers/norm2": leaves["layers/norm2"],
         "norm_f": leaves["norm_f"], "lm_head": leaves["lm_head"]}
    with torch.enable_grad():
        loss = _forward_loss(h0, W, labels, cfg, lowp, half)
        got = torch.autograd.grad(loss, [h0] + [leaves[p] for p in names])
    dt = P["embed"].dtype
    emb = torch.zeros(P["embed"].shape, dtype=F32, device=h0.device)
    emb.index_add_(0, tokens.reshape(-1), got[0].reshape(-1, d))
    grads = {"embed": emb.to(dt)}
    del emb
    grads.update((p, g.to(dt)) for p, g in zip(names, got[1:]))
    return loss.detach(), grads
