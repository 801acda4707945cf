"""Mixture-of-Experts FFN with top-k routing — ``repro/models/moe.py``
counterpart (qwen3-moe).

Sort-based dispatch (the grouped-GEMM layout): token assignments are
sorted by expert id (a stable sort, as ``jnp.argsort``: the rank within an
expert decides which tokens go over capacity), ranked within each expert
from segment offsets, clipped at the capacity C and scattered into an
(E, C, d) buffer, so the expert matmuls are three batched matmuls. An
assignment over capacity goes to one overflow row, which is dropped.
Router stats (load fraction, dropped fraction, the aux loss) feed the
load-balance regulariser.

``p`` is one layer's ``w_router`` (d, E) in f32, ``w_gate``/``w_up``
(E, d, f) and ``w_down`` (E, f, d), reached by attribute. The reference's
``shard_buffers`` is a sharding constraint for a device mesh and changes
nothing on one device; ``dispatch_shards`` > 1 (the reference's vmap over
token shards, each with its own capacity) is a loop over the shards.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _init


def moe_init(cfg: ModelConfig, *, generator=None, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
    """``w_router`` (d, E) in f32, ``w_gate``/``w_up`` (E, d, f) and
    ``w_down`` (E, f, d), drawn in this order."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
    kw = dict(generator=generator, dtype=dtype, device=device)
    # _init's default scale is 1/sqrt(shape[0]): the expert count, as the
    # reference's _init computes it for the (E, ., .) leaves
    return {"w_router": _init((d, e), scale=0.02,
                              **dict(kw, dtype=torch.float32)),
            "w_gate": _init((e, d, f), **kw),
            "w_up": _init((e, d, f), **kw),
            "w_down": _init((e, f, d), **kw)}


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    moe = cfg.moe
    # repro-torch: allow(step-sync) — host-only: the config's ints and a
    # token count
    c = int(moe.top_k * tokens * moe.capacity_factor / moe.n_experts) + 1
    return min(max(c, 4), tokens)


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), router stats ``aux_loss``,
    ``dropped_frac`` and ``load_frac`` (E,).

    A token over capacity gets nothing from that expert; its other top-k
    routes still apply. With ``dispatch_shards = N`` (and N dividing the
    tokens) the dispatch runs on each of N token shards with its own
    capacity, and the stats are the shards' means."""
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    D = max(1, moe.dispatch_shards)
    if D > 1 and T % D == 0:
        outs = [_moe_dispatch(p, xs, cfg)
                for xs in x.reshape(D, T // D, 1, d).unbind(0)]
        y = torch.stack([o[0] for o in outs]).reshape(B, S, d)
        stats = {k: torch.stack([o[1][k] for o in outs]).mean(dim=0)
                 for k in outs[0][1]}
        return y, stats
    return _moe_dispatch(p, x, cfg)


def _moe_dispatch(p, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    moe = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = moe.n_experts, moe.top_k
    xt = x.reshape(T, d)

    probs = torch.softmax(xt.to(torch.float32) @ p.w_router, dim=-1)
    gates, ids = torch.topk(probs, K, dim=-1)                 # (T, K)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    flat_ids = ids.reshape(-1)                                # (T*K,)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    # a scatter, not bincount: bincount sizes its output from the data,
    # which waits for the device
    counts = torch.zeros(E, dtype=flat_ids.dtype, device=x.device) \
        .scatter_add_(0, flat_ids, torch.ones_like(flat_ids))  # (E,)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T * K, device=x.device) - starts[sorted_ids]
    C = moe_capacity(cfg, T)
    keep = rank < C
    slot = torch.where(keep, sorted_ids * C + rank,
                       E * C)                                 # overflow row

    src_token = order // K                                    # per slot
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=x.device) \
        .index_put((slot,), xt[src_token])
    buf = buf[:-1].reshape(E, C, d)

    g = F.silu(torch.bmm(buf, p.w_gate))
    u = torch.bmm(buf, p.w_up)
    yb = torch.bmm(g * u, p.w_down)                           # (E, C, d)

    y_sorted = yb.reshape(E * C, d)
    gathered = torch.where(keep[:, None],
                           y_sorted[torch.clamp_max(slot, E * C - 1)], 0.0)
    # order is a permutation: the unsort writes every row once
    y_flat = torch.zeros((T * K, d), dtype=xt.dtype, device=x.device) \
        .index_copy(0, order, gathered)
    y = (y_flat.reshape(T, K, d) * gates.to(xt.dtype)[..., None]).sum(dim=1)

    # load-balance aux loss (Switch-style): E * sum_e f_e * p_e
    frac = counts.to(torch.float32) / torch.clamp_min(
        counts.sum().to(torch.float32), 1.0)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    stats = {"aux_loss": aux,
             "dropped_frac": 1.0 - keep.to(torch.float32).mean(),
             "load_frac": frac}
    return y.reshape(B, S, d), stats
