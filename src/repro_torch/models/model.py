"""Top-level model (``repro/models/model.py`` counterpart): embedding ->
block stack -> LM head.

  Model(cfg, device=None, generator=None, remat=False)   the parameters
  params() -> tree; load_params(tree)     the reference's parameter tree
  forward(batch) -> (logits, aux); loss(batch) -> (scalar, aux dict)
  init_cache(batch, max_len) -> cache
  decode_step(cache, batch) -> (logits, cache)   serve path

The parameters have the reference's layout: ``embed``, ``lm_head``,
``norm_f`` and ``layers``, whose leaves (``attn/w_q``, ..., ``mlp/w_down``,
``norm1``, ``norm2``) carry a leading L axis, as ``Model.init``'s
``lax.scan`` stack does. Each stacked leaf is held once, as one
``nn.Parameter``; layer i reads the views ``leaf[i]``
(``blocks.layer_view``), so the tree that the wire, the optimizer and the
checkpoint see is the parameters themselves and nothing is copied.
``forward``/``loss`` take an optional ``params`` tree of the same shape in
place of the module's own, as the reference's take ``p``.

Dense family only; the moe, hybrid, ssm, vlm and audio families wait for
later slices (ROADMAP A11.2). The reference's layer ``scan`` is a Python
loop; its ``remat`` (``jax.checkpoint`` over the scan body) is
``torch.utils.checkpoint`` per block, which changes memory, not numbers.
Its trace-time probe flags (``models/modes.py``, for the TPU dry-run) have
no counterpart.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (_init, cross_entropy, embed_init,
                                       rms_norm, stack_layer_params)


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class _Leaves(nn.Module):
    """A named group of stacked parameters (``attn``, ``mlp``)."""

    def __init__(self, leaves: Mapping[str, torch.Tensor]):
        super().__init__()
        for name, t in leaves.items():
            self.register_parameter(name, nn.Parameter(t))

    def tree(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())


class LayerStack(nn.Module):
    """The dense layer stack: ``attn`` (``w_q`` (L, d, Hq*dh), ``w_k``/``w_v``
    (L, d, Hkv*dh), ``w_o`` (L, Hq*dh, d)), ``mlp`` (``w_gate``/``w_up``
    (L, d, d_ff), ``w_down`` (L, d_ff, d)), ``norm1``/``norm2`` (L, d).
    Layer i's weights are drawn in the reference's ``dense_block_init``
    order (``w_q``, ``w_k``, ``w_v``, ``w_o``, ``w_gate``, ``w_up``,
    ``w_down``), layer after layer. ``blocks.layer_view(stack.tree(), i)``
    is layer i as views."""

    ATTN = ("w_q", "w_k", "w_v", "w_o")
    MLP = ("w_gate", "w_up", "w_down")

    def __init__(self, cfg: ModelConfig, *, generator=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        d, dh, f = cfg.d_model, cfg.head_dim, cfg.d_ff
        hq, hkv = cfg.n_heads * dh, cfg.n_kv_heads * dh
        shapes = ((d, hq), (d, hkv), (d, hkv), (hq, d), (d, f), (d, f),
                  (f, d))
        kw = dict(generator=generator, dtype=dtype, device=device)
        stacked = stack_layer_params(
            cfg.n_layers, lambda i: [_init(s, **kw) for s in shapes], shapes,
            dtype=dtype, device=device)
        self.n_layers = cfg.n_layers
        self.attn = _Leaves(dict(zip(self.ATTN, stacked[:4])))
        self.mlp = _Leaves(dict(zip(self.MLP, stacked[4:])))
        self.norm1 = nn.Parameter(torch.ones((cfg.n_layers, d), dtype=dtype,
                                             device=device))
        self.norm2 = nn.Parameter(torch.ones((cfg.n_layers, d), dtype=dtype,
                                             device=device))

    def tree(self) -> Dict[str, Any]:
        return {"attn": self.attn.tree(), "mlp": self.mlp.tree(),
                "norm1": self.norm1, "norm2": self.norm2}



class Model(nn.Module):
    """The parameters of ``cfg``, drawn from ``generator`` (a fresh one
    seeded with 0 on ``device`` when None) in ``cfg.dtype``: ``embed``
    (V, d), ``lm_head`` (d, V) unless tied, ``norm_f`` (d,) and the
    stacked ``layers``. On the ``meta`` device only the shapes are made.
    ``device`` defaults to the card (``repro_torch.resolve_device``).
    ``remat`` recomputes each block in the backward pass."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; only the dense "
                f"family is (ROADMAP A11.2)")
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.remat = remat
        dt = torch_dtype(cfg)
        kw = dict(generator=generator, dtype=dt, device=dev)
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                              device=dev))
        self.embed = nn.Parameter(embed_init(cfg.vocab, cfg.d_model, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(_init((cfg.d_model, cfg.vocab),
                                              scale=0.02, **kw))
        self.layers = LayerStack(cfg, **kw)

    # ------------------------------------------------------ the tree
    def params(self) -> Dict[str, Any]:
        """The reference's parameter tree, ``{embed, lm_head, norm_f,
        layers: {attn: {w_q, w_k, w_v, w_o}, mlp: {w_gate, w_up, w_down},
        norm1, norm2}}``, holding the module's parameters themselves (no
        copy): writing into a leaf writes the model."""
        tree = {"embed": self.embed, "norm_f": self.norm_f,
                "layers": self.layers.tree()}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        return tree

    @torch.no_grad()
    def load_params(self, tree: Mapping) -> "Model":
        """Copy a tree of :meth:`params`' shape into the parameters (each
        leaf cast to the parameter's dtype and device). Raises
        ``ValueError`` on a missing or extra leaf or a wrong shape."""
        from repro_torch.core.transport import leaf_paths, tree_leaves
        want = dict(zip(leaf_paths(self.params()),
                        tree_leaves(self.params())))
        got = dict(zip(leaf_paths(tree), tree_leaves(tree)))
        if set(want) != set(got):
            raise ValueError(f"tree leaves {sorted(got)} are not the "
                             f"model's {sorted(want)}")
        for path, p in want.items():
            if tuple(got[path].shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(got[path].shape)}, "
                                 f"the model has {tuple(p.shape)}")
            p.copy_(got[path])
        return self

    # ---------------------------------------------------------- forward
    def forward(self, batch: Dict[str, torch.Tensor],
                window: Optional[int] = None,
                params: Optional[Mapping] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B, S, V), aux_loss scalar). ``batch["tokens"]``:
        (B, S) integer ids; ``params`` (default: the module's own) is a
        tree of :meth:`params`' shape."""
        cfg = self.cfg
        p = self.params() if params is None else params
        win = cfg.sliding_window if window is None else window
        h = F.embedding(batch["tokens"], p["embed"])          # (B, S, d)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        remat = self.remat and torch.is_grad_enabled()
        for i in range(cfg.n_layers):
            lp = blocks.layer_view(p["layers"], i)
            if remat:
                h = checkpoint(blocks.dense_block, lp, h, cfg, win,
                               use_reentrant=False)
            else:
                h = blocks.dense_block(lp, h, cfg, window=win)
        h = rms_norm(h, p["norm_f"], cfg.norm_eps)
        head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        return h @ head, aux

    def loss(self, batch: Dict[str, torch.Tensor],
             params: Optional[Mapping] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy (f32) over ``batch["labels"]``
        (masked by ``batch["mask"]`` where given) plus 0.01 x the aux loss
        (zero for the dense family)."""
        logits, aux = self.forward(batch, params=params)
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, max_len: int) -> Dict:
        """``{"pos": 0, "attn": {"k": ..., "v": ...}}`` with k and v
        (L, batch, Smax, Hkv, dh) zeros in the model's dtype (the kernel
        takes q and the cache alike), Smax = min(max_len, window) for a
        sliding window (a ring buffer), else max_len. ``pos`` is a Python
        int: the next token's absolute position."""
        cfg = self.cfg
        dt = self.embed.dtype
        win = cfg.sliding_window
        attn_len = min(max_len, win) if win > 0 else max_len
        shape = (cfg.n_layers, batch, attn_len, cfg.n_kv_heads, cfg.head_dim)
        dev = self.embed.device
        return {"pos": 0,
                "attn": {"k": torch.zeros(shape, dtype=dt, device=dev),
                         "v": torch.zeros(shape, dtype=dt, device=dev)}}

    # ------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, cache: Dict, batch: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict]:
        """One-token step. ``batch["tokens"]``: (B, 1) integer ids.
        Returns (logits (B, 1, V), cache): the K/V of the token are written
        into ``cache`` in place and ``cache["pos"]`` is advanced, where the
        reference returns a new cache."""
        cfg = self.cfg
        pos = cache["pos"]
        h = self.embed[batch["tokens"]]                  # (B, 1, d)
        ks, vs = cache["attn"]["k"], cache["attn"]["v"]
        layers = self.layers.tree()
        for i in range(cfg.n_layers):
            h, _ = blocks.dense_block_decode(blocks.layer_view(layers, i), h,
                                             {"k": ks[i], "v": vs[i]}, pos,
                                             cfg)
        h = rms_norm(h, self.norm_f, cfg.norm_eps)
        head = self.embed.T if cfg.tie_embeddings else self.lm_head
        logits = h @ head
        cache["pos"] = pos + 1
        return logits, cache
