"""Zamba2 as published, plain: its parameter leaves, its weights from a
seed, one machine's loss and gradient in float32 with TF32 off, and the
quasi-Newton step over it (:class:`Zamba2QNReference`).

Written from the layer equations of Zamba2-7B-Instruct (hf:Zyphra/
Zamba2-7B-Instruct config.json; ``transformers``' ``Zamba2HybridLayer``,
``Zamba2AttentionDecoderLayer``, ``Zamba2MLP``, ``Zamba2MambaDecoderLayer``
and ``Zamba2MambaMixer.torch_forward``), with no kernel, cache or batching
of the program. With e the token embedding and h = e, every RMS norm at
``rms_norm_eps``:

* Mamba2 layer i: ``h + M_i(rms(h + t))``, t insertion j's output where i
  is a hybrid layer (the j-th), else 0;
* insertion j, shared block b = j mod ``num_mem_blocks``: ``x =
  rms([h ‖ e])``; q, k, v = x W (``attention_hidden_size`` wide), rotary
  embedding over the whole head (``rotate_half``, theta ``rope_theta``),
  causal softmax attention at scale (``attention_head_dim`` / 2) ** -0.5;
  ``u = rms(attn W_o)``; ``[g ‖ v'] = u W_gu + (u A_j) B_j``; ``t =
  ((gelu(g) * v') W_down) L_j``;
* mixer M: ``[z ‖ xBC ‖ dt] = x W_in``; a causal depthwise conv of width
  ``mamba_d_conv`` plus bias, SiLU; split into x, B, C (``mamba_ngroups``
  groups, head h on group ``h // (H / G)``); ``dt = max(softplus(dt +
  dt_bias), time_step_min)``; the SSD scan with ``A = -exp(a_log)``, plus
  ``D x``; ``w * grouprms(y * silu(z))`` in groups of d_inner / G;
  ``W_out``;
* head: ``rms(h) E^T`` with the tied embedding E; the mean next-token
  cross entropy.

The scan is the chunked form of the Mamba2 paper's minimal listing
(``ssd``): segment sums within each chunk of ``chunk_size``, the states
at the chunks' ends, and a segment sum over the chunks, with no loop.
Each layer and each insertion is recomputed in the backward pass
(``torch.utils.checkpoint``) so that one layer's float32 activations are
held at a time. Weights are held in their storage dtype and widened to
float32 where used; each gradient is computed in float32 and rounded
once to its leaf's dtype (bf16, or float32 for ``a_log``, ``dt_bias`` and
``d_skip``).

``lowp="fp8"`` is the control: every matrix product of the model (the
projections, attention's two products, the head) takes its operands, and
its backward its incoming gradient, through a scaled fp8 rounding, as in
``bench.reference.glm4``. ``lowp="bf16scan"`` is a reading, not a
control: the scan alone in bf16 (its inputs rounded and its segment sums,
exponentials and products taken in bf16), the step a later change to the
scan would be tempted by.

The faults the check must catch, planted here in the program's place:
``half`` (the mean over the first half of the positions), ``noembed``
(the shared blocks read zeros in place of e), ``noadapter`` (the
adapters left out); :class:`Zamba2QNReference` adds ``alter`` on a
Mamba2 leaf and the noise faults of ``bench.reference.qn_step``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.glm4 import _mm
from bench.reference.qn_step import QNReference

F32 = torch.float32
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: leaves kept in float32 in a bf16 model
F32_LEAVES = ("layers/ssm/a_log", "layers/ssm/d_skip", "layers/ssm/dt_bias")
#: the Mamba2 leaf whose aggregate the "alter" fault doubles
ALTERED = "layers/ssm/w_in"


def _dims(c: Dict):
    d = c["hidden_size"]
    di = c["mamba_expand"] * d
    G, N = c["mamba_ngroups"], c["mamba_d_state"]
    return d, di, c["n_mamba_heads"], G, N, di + 2 * G * N


def leaf_specs(c: Dict) -> List[Tuple[str, tuple, Optional[float]]]:
    """``(path, shape, init)`` of every leaf, in the wire's order (paths
    sorted); init is a scale of standard normals, or ``"ones"``,
    ``"a_log"`` (log 1..H per layer) or ``"dt_bias"`` (drawn)."""
    L, V = c["num_hidden_layers"], c["vocab_size"]
    d, di, H, G, N, conv = _dims(c)
    n_ins, nb = len(c["hybrid_layer_ids"]), c["num_mem_blocks"]
    f, r, a = c["intermediate_size"], c["adapter_rank"], \
        c["attention_hidden_size"]
    hq = c["num_attention_heads"] * c["attention_head_dim"]
    k = c["mamba_d_conv"]
    specs = [
        ("embed", (V, d), 0.02),
        ("insertions/adapter_a", (n_ins, d, r), 1 / math.sqrt(d)),
        ("insertions/adapter_b", (n_ins, r, 2 * f), 1 / math.sqrt(r)),
        ("insertions/linear", (n_ins, d, d), 1 / math.sqrt(d)),
        ("layers/norm", (L, d), "ones"),
        ("layers/ssm/a_log", (L, H), "a_log"),
        ("layers/ssm/conv_b", (L, conv), 1 / math.sqrt(k)),
        ("layers/ssm/conv_w", (L, k, conv), 1 / math.sqrt(k)),
        ("layers/ssm/d_skip", (L, H), "ones"),
        ("layers/ssm/dt_bias", (L, H), "dt_bias"),
        ("layers/ssm/norm", (L, di), "ones"),
        ("layers/ssm/w_in", (L, d, di + conv + H), 1 / math.sqrt(d)),
        ("layers/ssm/w_out", (L, di, d), 1 / math.sqrt(di)),
        ("norm_f", (d,), "ones"),
        ("shared_blocks/attn/w_k", (nb, a, hq), 1 / math.sqrt(a)),
        ("shared_blocks/attn/w_o", (nb, hq, d), 1 / math.sqrt(hq)),
        ("shared_blocks/attn/w_q", (nb, a, hq), 1 / math.sqrt(a)),
        ("shared_blocks/attn/w_v", (nb, a, hq), 1 / math.sqrt(a)),
        ("shared_blocks/mlp/w_down", (nb, f, d), 1 / math.sqrt(f)),
        ("shared_blocks/mlp/w_gate_up", (nb, d, 2 * f), 1 / math.sqrt(d)),
        ("shared_blocks/norm1", (nb, a), "ones"),
        ("shared_blocks/norm2", (nb, d), "ones"),
    ]
    return sorted(specs)


def leaf_dtype(c: Dict, path: str) -> torch.dtype:
    return F32 if path in F32_LEAVES else DTYPES[c["dtype"]]


def make_params(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf's initial weights from the generator seeded with
    ``seed``: the random leaves as views of one flat buffer of standard
    normals drawn in the storage dtype in one call, each leaf's span
    times its scale; then ``dt_bias`` = softplus^-1(dt), dt = exp(U(log
    1e-3, log 0.1)) floored at ``time_step_floor``, from one draw of
    uniforms in float32 (transformers' init); ``a_log`` = log(1..H); norm
    weights and ``d_skip`` ones. The same call gives the same tensors."""
    specs = leaf_specs(c)
    dt = DTYPES[c["dtype"]]
    g = torch.Generator(device=device).manual_seed(seed)
    rand = [(p, s, k) for p, s, k in specs if isinstance(k, float)]
    sizes = [math.prod(s) for _, s, _ in rand]
    flat = torch.randn(sum(sizes), generator=g, dtype=dt, device=device)
    out = {}
    for (path, shape, scale), part in zip(rand, flat.split(sizes)):
        out[path] = part.mul_(scale).view(shape)
    for path, shape, kind in specs:
        kw = dict(dtype=leaf_dtype(c, path), device=device)
        if kind == "ones":
            out[path] = torch.ones(shape, **kw)
        elif kind == "a_log":
            out[path] = torch.log(torch.arange(
                1, shape[1] + 1, dtype=F32, device=device)).expand(
                    shape).contiguous()
        elif kind == "dt_bias":
            lo, hi = math.log(c["time_step_min"]), math.log(
                c["time_step_max"])
            u = torch.rand(shape, generator=g, dtype=F32, device=device)
            step = torch.exp(u * (hi - lo) + lo).clamp_min(
                c["time_step_floor"])
            out[path] = step + torch.log(-torch.expm1(-step))
    return out


# ------------------------------------------------------------ the model

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.to(F32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, dh): ``x cos + rotate_half(x) sin``."""
    S, dh = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=F32,
                                       device=x.device) / dh)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * inv
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    half = torch.cat([-x[..., dh // 2:], x[..., :dh // 2]], dim=-1)
    return x * cos + half * sin


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): [i, j] the sum of a over (j, i], -inf
    above the diagonal."""
    T = a.shape[-1]
    low = torch.ones(T, T, dtype=torch.bool, device=a.device)
    a = a[..., None].expand(*a.shape, T).masked_fill(~low.tril(-1), 0)
    return torch.cumsum(a, dim=-2).masked_fill(~low.tril(), -torch.inf)


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD scan, chunked as in the Mamba2 paper's minimal listing. x
    (b, l, h, p), dt (b, l, h), A (h,), B and C (b, l, h, n), one per
    head; l a multiple of ``chunk`` or padded to one. Computes in x's
    dtype."""
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
    L = torch.exp(_segsum(Ad))
    y = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", Cp, Bp, L, X)
    decay = torch.exp(cum[..., -1:] - cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", Bp, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(_segsum(F.pad(cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", Cp, states,
                         torch.exp(cum))
    return y.reshape(b, c * chunk, h, p)[:, :l]


def _mixer(W, x, c: Dict, lowp):
    d, di, H, G, N, conv = _dims(c)
    hd = c["mamba_headdim"]
    b, l, _ = x.shape
    z, xbc, dt = _mm(x, W["w_in"].to(F32), lowp).split([di, conv, H], -1)
    k = c["mamba_d_conv"]
    xbc = F.conv1d(xbc.transpose(1, 2), W["conv_w"].to(F32).T[:, None, :],
                   W["conv_b"].to(F32), padding=k - 1, groups=conv)
    xbc = F.silu(xbc[..., :l].transpose(1, 2))
    xs, Bm, Cm = xbc.split([di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + W["dt_bias"]).clamp_min(c["time_step_min"])
    A = -torch.exp(W["a_log"])
    xs = xs.reshape(b, l, H, hd)
    Bm = Bm.reshape(b, l, G, N).repeat_interleave(H // G, dim=2)
    Cm = Cm.reshape(b, l, G, N).repeat_interleave(H // G, dim=2)
    if lowp == "bf16scan":
        bf = torch.bfloat16
        y = ssd(xs.to(bf), dt.to(bf), A.to(bf), Bm.to(bf), Cm.to(bf),
                c["chunk_size"]).to(F32)
    else:
        y = ssd(xs, dt, A, Bm, Cm, c["chunk_size"])
    y = (y + W["d_skip"][:, None] * xs).reshape(b, l, di)
    y = (y * F.silu(z)).reshape(b, l, G, di // G)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True)
                        + c["rms_norm_eps"])
    y = y.reshape(b, l, di) * W["norm"].to(F32)
    return _mm(y, W["w_out"].to(F32), lowp)


def _mamba_layer(h, t, norm, W, c, lowp):
    x = h if t is None else h + t
    return h + _mixer(W, _rms(x, norm, c["rms_norm_eps"]), c, lowp)


def _shared(h, e, Wb, A, B, Lj, c, lowp, fault):
    eps = c["rms_norm_eps"]
    if fault == "noembed":
        e = torch.zeros_like(e)
    x = _rms(torch.cat([h, e], dim=-1), Wb["norm1"], eps)
    b, l, _ = x.shape
    H, dh = c["num_attention_heads"], c["attention_head_dim"]
    theta = c["rope_theta"]
    q = _rope(_mm(x, Wb["w_q"].to(F32), lowp).reshape(b, l, H, dh), theta)
    k = _rope(_mm(x, Wb["w_k"].to(F32), lowp).reshape(b, l, H, dh), theta)
    v = _mm(x, Wb["w_v"].to(F32), lowp).reshape(b, l, H, dh)
    q, k, v = (y.transpose(1, 2) for y in (q, k, v))         # b H l dh
    scores = _mm(q, k.transpose(-1, -2), lowp) * (dh / 2) ** -0.5
    causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
    pr = torch.softmax(scores.masked_fill(~causal, -torch.inf), dim=-1)
    a = _mm(pr, v, lowp).transpose(1, 2).reshape(b, l, H * dh)
    u = _rms(_mm(a, Wb["w_o"].to(F32), lowp), Wb["norm2"], eps)
    gu = _mm(u, Wb["w_gate_up"].to(F32), lowp)
    if fault != "noadapter":
        gu = gu + _mm(_mm(u, A.to(F32), lowp), B.to(F32), lowp)
    g, up = gu.chunk(2, dim=-1)
    return _mm(_mm(F.gelu(g) * up, Wb["w_down"].to(F32), lowp),
               Lj.to(F32), lowp)


def _forward_loss(E, leaves, tokens, labels, c, lowp, fault):
    eps = c["rms_norm_eps"]
    e = F.embedding(tokens, E)
    h, j = e, 0
    nb = c["num_mem_blocks"]
    hybrid = set(c["hybrid_layer_ids"])
    for i in range(c["num_hidden_layers"]):
        t = None
        if i in hybrid:
            b = j % nb
            Wb = {k.rsplit("/", 1)[1]: v[b] for k, v in leaves.items()
                  if k.startswith("shared_blocks/")}
            t = checkpoint(_shared, h, e, Wb,
                           leaves["insertions/adapter_a"][j],
                           leaves["insertions/adapter_b"][j],
                           leaves["insertions/linear"][j], c, lowp, fault,
                           use_reentrant=False)
            j += 1
        W = {k.rsplit("/", 1)[1]: v[i] for k, v in leaves.items()
             if k.startswith("layers/ssm/")}
        h = checkpoint(_mamba_layer, h, t, leaves["layers/norm"][i], W, c,
                       lowp, use_reentrant=False)
    logits = _mm(_rms(h, leaves["norm_f"], eps), E.T, lowp)
    nll = torch.logsumexp(logits, dim=-1) \
        - torch.gather(logits, -1, labels[..., None])[..., 0]
    return nll[:, :nll.shape[1] // 2].mean() if fault == "half" \
        else nll.mean()


def loss_and_grads(P: Dict[str, torch.Tensor], tokens: torch.Tensor,
                   labels: torch.Tensor, c: Dict,
                   lowp: Optional[str] = None, fault: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One machine's mean next-token cross entropy over ``tokens`` (B, S)
    and ``labels`` at the parameters ``P`` (path -> tensor), in float32
    with TF32 off, and its gradient per leaf in the leaf's dtype. Returns
    ``(loss (float32 scalar), grads)``. ``lowp`` and ``fault`` as in the
    module's docstring."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = [p for p, _, _ in leaf_specs(c) if p != "embed"]
    leaves = {p: P[p].detach().requires_grad_() for p in names}
    E = P["embed"].detach().to(F32).requires_grad_()
    with torch.enable_grad():
        loss = _forward_loss(E, leaves, tokens, labels, c, lowp, fault)
        want = [E] + [leaves[p] for p in names]
        got = torch.autograd.grad(loss, want, allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for x, g in zip(want, got)]
    grads = {"embed": got[0].to(P["embed"].dtype)}
    grads.update((p, g.to(P[p].dtype)) for p, g in zip(names, got[1:]))
    return loss.detach(), grads


class Zamba2QNReference(QNReference):
    """``bench.reference.qn_step``'s plain protocol step over this model:
    each machine's gradient from :func:`loss_and_grads`; the faults of
    the base, with ``alter`` doubling the aggregated gradient of a Mamba2
    leaf (``ALTERED``), and ``noembed`` and ``noadapter`` planted in the
    model."""

    def _grad(self, params, batch, j):
        return loss_and_grads(params, batch["tokens"][j],
                              batch["labels"][j], self.cfg, self.lowp,
                              self.fault)

    def _tx(self, gens, slot, stack, post=None):
        if self.fault == "alter" and slot == "R2":
            def post(k, red):
                return red * 2 if k == ALTERED else red
        return super()._tx(gens, slot, stack, post)
