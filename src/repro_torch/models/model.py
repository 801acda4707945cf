"""Top-level model (``repro/models/model.py`` counterpart): embedding ->
block stack -> LM head, for the dense, vlm, audio, moe, hybrid and ssm
families.

  Model(cfg, device=None, generator=None, remat=False)   the parameters
  params() -> tree; load_params(tree)     the reference's parameter tree
  forward(batch) -> (logits, aux); loss(batch) -> (scalar, aux dict)
  init_cache(batch, max_len) -> cache
  decode_step(cache, batch) -> (logits, cache)   serve path

The parameters have the reference's layout: ``embed``, ``lm_head``,
``norm_f`` and the family's blocks:

  dense   ``layers``: ``attn/{w_q, w_k, w_v, w_o}``, ``mlp/{w_gate, w_up,
          w_down}``, ``norm1``, ``norm2``, each on a leading L axis;
  vlm     the dense ``layers`` and a ``projector`` (VISION_DIM, d) that
          maps the stub vision tower's ``patch_embeds`` (B, n_patches,
          VISION_DIM) into the model, prepended to the text and not
          scored by the loss;
  audio   the dense ``layers``; ``embed`` is (n_codebooks, V, d) and the
          tokens (B, S, n_codebooks), whose embeddings are summed;
  moe     ``layers``: ``attn``, ``moe/{w_router, w_gate, w_up, w_down}``,
          ``norm1``, ``norm2``, stacked; the aux loss is summed over layers;
  hybrid  ``layers``: ``norm``, ``ssm/{w_in, conv_w, conv_b, a_log,
          dt_bias, d_skip, w_out}``, stacked, and one unstacked
          ``shared_attn`` (a dense block's leaves) applied after layer i
          when i % attn_every == attn_every - 1;
  ssm     ``xlstm_layers``: a list of L per-layer trees ``{norm, mixer}``,
          the mixer an sLSTM at ``cfg.slstm_at`` and an mLSTM elsewhere.

Zamba2 as published (a hybrid ``Zamba2Config``, the port's own) holds
``layers`` (``norm`` and ``ssm``, whose mixer adds the gated norm's
``norm``), ``shared_blocks`` (``norm1``, ``attn``, ``norm2``,
``mlp/{w_gate_up, w_down}``, stacked over its ``num_mem_blocks``) and
``insertions`` (``adapter_a``, ``adapter_b``, ``linear``, stacked over
its insertions), with the tied embedding as the head and no ``lm_head``.
It trains and evaluates (``forward``, ``loss``); it has no decode. Each
of its Mamba2 layers runs under the span ``repro.ssm`` and each
insertion under ``repro.shared`` (``obs.block_span``), backward and
recompute included.

Each leaf is held once, as one ``nn.Parameter``; a layer reads the views
``leaf[i]`` of a stacked leaf (``blocks.layer_view``), so the tree that
the wire, the optimizer and the checkpoint see is the parameters
themselves and nothing is copied. Leaves that the reference keeps in f32
(``w_if``/``b_if``, ``r_h``/``b``, ``w_router``, ``a_log``/``dt_bias``/
``d_skip``) are f32 in a bf16 model too. ``forward``/``loss`` take an
optional ``params`` tree of the same shape in place of the module's own,
as the reference's take ``p``.

The reference's layer ``scan`` is a Python loop; its ``remat``
(``jax.checkpoint`` over the scan body) is ``torch.utils.checkpoint`` per
block, which changes memory, not numbers. Its trace-time probe flags
(``models/modes.py``, for the TPU dry-run) have no counterpart.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import obs, resolve_device
from repro_torch.configs.base import ModelConfig, Zamba2Config
from repro_torch.core.transport import (active_payload, leaf_paths,
                                        tree_flatten, tree_leaves,
                                        tree_unflatten)
from repro_torch.models import attention, blocks, moe, ssm, xlstm
from repro_torch.models.layers import (_init, cross_entropy, embed_init,
                                       mlp_init, rms_norm)

#: the families whose blocks the port has (all of the reference's)
FAMILIES = ("dense", "vlm", "audio", "moe", "hybrid", "ssm")
#: the families on the dense block stack and the dense cache
DENSE = ("dense", "vlm", "audio")
#: the stub vision tower's output width, which the vlm's projector maps to
#: d_model (the reference's VISION_DIM)
VISION_DIM = 1024


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class ParamTree(nn.Module):
    """A nested dict of parameters: each tensor an ``nn.Parameter``, each
    dict a child ``ParamTree``. :meth:`tree` gives the dict back, holding
    the parameters themselves."""

    def __init__(self, leaves: Mapping):
        super().__init__()
        for name, node in leaves.items():
            if isinstance(node, Mapping):
                self.add_module(name, ParamTree(node))
            else:
                self.register_parameter(name, nn.Parameter(node))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


def stack_layers(n_layers: int, make: Callable[[int], Mapping]) -> Dict:
    """The reference's ``stack_layer_params``: L layers of the tree
    ``make(i)`` stacked leaf by leaf on a leading axis, each leaf in its
    own dtype. Layer i is drawn in full before layer i + 1 (the draws come
    in a per-layer init's order) and written into slice i as it is made,
    so the stack is never held twice. On the ``meta`` device only the
    shapes are made."""
    first, treedef = tree_flatten(make(0))
    out = [torch.empty((n_layers,) + tuple(x.shape), dtype=x.dtype,
                       device=x.device) for x in first]
    if first[0].device.type != "meta":
        for i in range(n_layers):
            for dst, src in zip(out, first if i == 0
                                else tree_leaves(make(i))):
                dst[i].copy_(src)
    return tree_unflatten(treedef, out)


def _gathered(fn):
    """``fn`` with its views' sharded leaves gathered first
    (``blocks.full``), so the gather runs inside a rematerialised
    region."""
    def call(*args):
        return fn(*(blocks.full(a) for a in args))
    return call


def _run(remat: bool, fn, *args):
    """``fn(*args)`` on the gathered views, recomputed in the backward
    pass when ``remat``."""
    if remat:
        return checkpoint(_gathered(fn), *args, use_reentrant=False)
    return _gathered(fn)(*args)


#: the leaves outside the block stack, read whole where they are used
_TOP = ("embed", "lm_head", "projector", "norm_f")


def _top(p: Mapping) -> Mapping:
    """``p`` with the top-level leaves gathered under a payload sharding
    (the blocks' leaves are gathered layer by layer)."""
    pl = active_payload()
    if pl is None:
        return p
    return {k: pl.gather(v, k) if k in _TOP else v for k, v in p.items()}


def _xlstm_layer(lp, h: torch.Tensor, cfg: ModelConfig,
                 slstm: bool) -> torch.Tensor:
    x = rms_norm(h, lp.norm, cfg.norm_eps)
    mix = xlstm.slstm_forward if slstm else xlstm.mlstm_forward
    return h + mix(lp.mixer, x, cfg)


def _hybrid_layer(lp, h: torch.Tensor, shared, cfg: ModelConfig,
                  attn: bool, window: int) -> torch.Tensor:
    h = blocks.mamba_block(lp, h, cfg)
    if attn:
        h = blocks.shared_attn_block(shared, h, cfg, window=window)
    return h


def _zamba2_stack(p, h: torch.Tensor, cfg: Zamba2Config,
                  remat: bool) -> torch.Tensor:
    """Zamba2 as published over the embedding h: each Mamba2 layer, the
    layers at ``cfg.hybrid_layers`` after an insertion of the shared
    blocks in turn, each block and each Mamba2 layer rematerialised on
    its own and under its span."""
    e, j = h, 0
    for i in range(cfg.n_layers):
        t = None
        if i in cfg.hybrid_layers:
            sp = obs.block_span("repro.shared")
            h_in, e_in = sp.enter(h, e)
            b = j % cfg.num_mem_blocks
            t = _run(remat, blocks.zamba2_shared_block,
                     blocks.layer_view(p["shared_blocks"], b,
                                       "shared_blocks"),
                     blocks.layer_view(p["insertions"], j, "insertions"),
                     h_in, e_in, cfg)
            t, = sp.exit(t)
            j += 1
        sp = obs.block_span("repro.ssm")
        h, t = sp.enter(h, t)
        h = _run(remat, blocks.zamba2_mamba_block,
                 blocks.layer_view(p["layers"], i), h, t, cfg)
        h, = sp.exit(h)
    return h


class Model(nn.Module):
    """The parameters of ``cfg``, drawn from ``generator`` (a fresh one
    seeded with 0 on ``device`` when None) in ``cfg.dtype``, the f32
    leaves in f32: ``embed`` (V, d), ``lm_head`` (d, V) unless tied,
    ``norm_f`` (d,) and the family's blocks, drawn layer by layer. On the
    ``meta`` device only the shapes are made. ``device`` defaults to the
    card (``repro_torch.resolve_device``). ``remat`` recomputes each block
    in the backward pass."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; the families "
                             f"are {FAMILIES}")
        dev = resolve_device(device)
        if generator is None and dev.type != "meta":
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.remat = remat
        self.zamba2 = isinstance(cfg, Zamba2Config)
        if self.zamba2 and (not cfg.tie_embeddings or cfg.attn_every):
            raise ValueError("Zamba2 as published has a tied embedding "
                             "and no attn_every")
        self.n_shared = (cfg.n_layers // cfg.attn_every
                         if cfg.family == "hybrid" and cfg.attn_every > 0
                         else 0)
        dt = torch_dtype(cfg)
        kw = dict(generator=generator, dtype=dt, device=dev)
        self.norm_f = nn.Parameter(torch.ones(cfg.d_model, dtype=dt,
                                              device=dev))
        if cfg.family == "audio":           # (n_codebooks, V, d)
            self.embed = nn.Parameter(torch.stack([
                embed_init(cfg.vocab, cfg.d_model, **kw)
                for _ in range(cfg.n_codebooks)]))
        else:
            self.embed = nn.Parameter(embed_init(cfg.vocab, cfg.d_model,
                                                 **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(_init((cfg.d_model, cfg.vocab),
                                              scale=0.02, **kw))
        if cfg.family == "vlm":
            self.projector = nn.Parameter(_init((VISION_DIM, cfg.d_model),
                                                **kw))
        L, d = cfg.n_layers, cfg.d_model

        def norm():
            return torch.ones(d, dtype=dt, device=dev)
        if cfg.family in DENSE:
            self.layers = ParamTree(stack_layers(L, lambda i: {
                "norm1": norm(), "attn": attention.attn_init(cfg, **kw),
                "norm2": norm(), "mlp": mlp_init(d, cfg.d_ff, **kw)}))
        elif cfg.family == "moe":
            self.layers = ParamTree(stack_layers(L, lambda i: {
                "norm1": norm(), "attn": attention.attn_init(cfg, **kw),
                "norm2": norm(), "moe": moe.moe_init(cfg, **kw)}))
        elif self.zamba2:
            self.layers = ParamTree(stack_layers(L, lambda i: {
                "norm": norm(), "ssm": ssm.ssm_init(cfg, **kw)}))
            self.shared_blocks = ParamTree(stack_layers(
                cfg.num_mem_blocks,
                lambda b: blocks.zamba2_shared_init(cfg, **kw)))
            self.insertions = ParamTree(stack_layers(
                len(cfg.hybrid_layers),
                lambda j: blocks.zamba2_insertion_init(cfg, **kw)))
        elif cfg.family == "hybrid":
            self.layers = ParamTree(stack_layers(L, lambda i: {
                "norm": norm(), "ssm": ssm.ssm_init(cfg, **kw)}))
            self.shared_attn = ParamTree({
                "norm1": norm(), "attn": attention.attn_init(cfg, **kw),
                "norm2": norm(),
                "mlp": mlp_init(d, cfg.d_ff, **kw)})
        else:
            self.xlstm_layers = nn.ModuleList(
                ParamTree(blocks.xlstm_block_init(cfg, i, **kw))
                for i in range(L))

    # ------------------------------------------------------ the tree
    def params(self) -> Dict[str, Any]:
        """The reference's parameter tree (``embed``, ``lm_head``,
        ``norm_f``, the vlm's ``projector`` and the family's blocks, see
        the module docstring),
        holding the module's parameters themselves (no copy): writing
        into a leaf writes the model."""
        tree: Dict[str, Any] = {"embed": self.embed, "norm_f": self.norm_f}
        if not self.cfg.tie_embeddings:
            tree["lm_head"] = self.lm_head
        if self.cfg.family == "vlm":
            tree["projector"] = self.projector
        if self.cfg.family == "ssm":
            tree["xlstm_layers"] = [m.tree() for m in self.xlstm_layers]
        else:
            tree["layers"] = self.layers.tree()
        if self.zamba2:
            tree["shared_blocks"] = self.shared_blocks.tree()
            tree["insertions"] = self.insertions.tree()
        elif self.cfg.family == "hybrid":
            tree["shared_attn"] = self.shared_attn.tree()
        return tree

    @torch.no_grad()
    def load_params(self, tree: Mapping) -> "Model":
        """Copy a tree of :meth:`params`' shape into the parameters (each
        leaf cast to the parameter's dtype and device). Raises
        ``ValueError`` on a missing or extra leaf or a wrong shape."""
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

    # ------------------------------------------------------------ embed
    def _embed(self, p: Mapping, batch: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
        """(B, S, d): the tokens' embeddings; audio sums its codebooks'
        (tokens (B, S, nc)), in order from codebook 0 as the reference's
        ``sum``; the vlm prepends its projected ``patch_embeds`` where the
        batch has them."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if cfg.family == "audio":
            h = F.embedding(tokens[..., 0], p["embed"][0])
            for c in range(1, cfg.n_codebooks):
                h = h + F.embedding(tokens[..., c], p["embed"][c])
        else:
            h = F.embedding(tokens, p["embed"])
        if cfg.family == "vlm" and "patch_embeds" in batch:
            patches = batch["patch_embeds"].to(h.dtype) @ p["projector"]
            h = torch.cat([patches, h], dim=1)
        return h

    # ---------------------------------------------------------- forward
    def forward(self, batch: Dict[str, torch.Tensor],
                window: Optional[int] = None,
                params: Optional[Mapping] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits (B, S, V), aux_loss scalar: the moe layers' sum,
        else 0). ``batch["tokens"]``: (B, S) integer ids, (B, S, nc) for
        audio; the vlm's optional ``patch_embeds`` (B, P, VISION_DIM) make
        the logits (B, P + S, V). ``params`` (default: the module's own)
        is a tree of :meth:`params`' shape."""
        cfg = self.cfg
        p = _top(self.params() if params is None else params)
        win = cfg.sliding_window if window is None else window
        h = self._embed(p, batch)                             # (B, S, d)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        remat = self.remat and torch.is_grad_enabled()
        if self.zamba2:
            h = _zamba2_stack(p, h, cfg, remat)
        elif cfg.family == "ssm":
            for i, layer in enumerate(p["xlstm_layers"]):
                h = _run(remat, _xlstm_layer,
                         blocks.tree_view(layer, f"xlstm_layers/{i}"), h,
                         cfg, i in cfg.slstm_at)
        elif cfg.family == "hybrid":
            shared = blocks.tree_view(p["shared_attn"], "shared_attn") \
                if self.n_shared else None
            every = cfg.attn_every
            for i in range(cfg.n_layers):
                attn = every > 0 and i % every == every - 1
                h = _run(remat, _hybrid_layer,
                         blocks.layer_view(p["layers"], i), h, shared, cfg,
                         attn, win)
        else:
            block = blocks.moe_block if cfg.family == "moe" \
                else blocks.dense_block
            for i in range(cfg.n_layers):
                out = _run(remat, block, blocks.layer_view(p["layers"], i),
                           h, cfg, win)
                if cfg.family == "moe":
                    h, a = out
                    aux = aux + a
                else:
                    h = out
        h = rms_norm(h, p["norm_f"], cfg.norm_eps)
        head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        return h @ head, aux

    def loss(self, batch: Dict[str, torch.Tensor],
             params: Optional[Mapping] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Mean next-token cross entropy (f32) over ``batch["labels"]``
        (masked by ``batch["mask"]`` where given) plus 0.01 x the aux loss
        (the moe layers' load-balance loss; zero for the other
        families). The vlm scores only the text positions, after its
        patches."""
        logits, aux = self.forward(batch, params=params)
        if self.cfg.family == "vlm" and "patch_embeds" in batch:
            logits = logits[:, batch["patch_embeds"].shape[1]:]
        ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------ cache
    def init_cache(self, batch: int, max_len: int) -> Dict:
        """``{"pos": 0, ...}``, ``pos`` a Python int (the next token's
        absolute position), and the family's state:

          dense, vlm, audio, moe
                      ``attn``: k and v (L, batch, Smax, Hkv, dh) zeros in
                      the model's dtype (the kernel takes q and the cache
                      alike), Smax = min(max_len, window) for a sliding
                      window (a ring buffer), else max_len;
          hybrid      ``ssm``: ``state`` (L, batch, H, N, headdim) and
                      ``conv`` (L, batch, d_conv - 1, conv_dim) f32 zeros,
                      and ``attn`` as above with one entry per shared
                      attention insertion in place of L;
          ssm         ``xlstm``: a list of L per-layer caches (f32), an
                      sLSTM's or an mLSTM's."""
        cfg = self.cfg
        if self.zamba2:
            raise NotImplementedError("Zamba2 as published has no decode "
                                      "in the port")
        dt = self.embed.dtype
        dev = self.embed.device
        win = cfg.sliding_window
        attn_len = min(max_len, win) if win > 0 else max_len
        cache: Dict[str, Any] = {"pos": 0}

        def kv(n):
            shape = (n, batch, attn_len, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.family in DENSE + ("moe",):
            cache["attn"] = kv(cfg.n_layers)
        elif cfg.family == "hybrid":
            one = ssm.ssm_cache_init(cfg, batch, dev)
            cache["ssm"] = {k: v[None].repeat((cfg.n_layers,) + (1,) * v.dim())
                            for k, v in one.items()}
            if self.n_shared:
                cache["attn"] = kv(self.n_shared)
        else:
            cache["xlstm"] = [
                (xlstm.slstm_cache_init if i in cfg.slstm_at
                 else xlstm.mlstm_cache_init)(cfg, batch, dev)
                for i in range(cfg.n_layers)]
        return cache

    # ------------------------------------------------------- decode step
    @torch.no_grad()
    def decode_step(self, cache: Dict, batch: Dict[str, torch.Tensor],
                    params: Optional[Mapping] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """One-token step. ``batch["tokens"]``: (B, 1) integer ids, (B, 1,
        nc) for audio (the vlm's ``patch_embeds`` are dropped, as the
        reference drops them). Returns (logits (B, 1, V), cache): the
        token's K/V and the
        recurrent states are written into ``cache`` in place and
        ``cache["pos"]`` is advanced, where the reference returns a new
        cache. ``params`` as in :meth:`forward` (a rank's slices under a
        payload sharding)."""
        cfg = self.cfg
        pos = cache["pos"]
        p = _top(self.params() if params is None else params)
        full = blocks.full
        h = self._embed(p, {k: v for k, v in batch.items()
                            if k != "patch_embeds"})       # (B, 1, d)
        if cfg.family in DENSE + ("moe",):
            ks, vs = cache["attn"]["k"], cache["attn"]["v"]
            dec = blocks.moe_block_decode if cfg.family == "moe" \
                else blocks.dense_block_decode
            for i in range(cfg.n_layers):
                h, _ = dec(full(blocks.layer_view(p["layers"], i)), h,
                           {"k": ks[i], "v": vs[i]}, pos, cfg)
        elif cfg.family == "hybrid":
            st = cache["ssm"]
            every = cfg.attn_every
            shared = full(blocks.tree_view(p["shared_attn"], "shared_attn")) \
                if self.n_shared else None
            for i in range(cfg.n_layers):
                h, new = blocks.mamba_block_decode(
                    full(blocks.layer_view(p["layers"], i)), h,
                    {k: v[i] for k, v in st.items()}, cfg)
                for k, v in new.items():
                    st[k][i].copy_(v)
                if self.n_shared and i % every == every - 1:
                    j = i // every
                    h, _ = blocks.shared_attn_block_decode(
                        shared, h, {k: v[j] for k, v in
                                    cache["attn"].items()}, pos, cfg)
        else:
            for i, layer in enumerate(p["xlstm_layers"]):
                lp = full(blocks.tree_view(layer, f"xlstm_layers/{i}"))
                dec = xlstm.slstm_decode if i in cfg.slstm_at \
                    else xlstm.mlstm_decode
                y, new = dec(lp.mixer, rms_norm(h, lp.norm, cfg.norm_eps),
                             cache["xlstm"][i], cfg)
                h = h + y
                for k, v in new.items():
                    cache["xlstm"][i][k].copy_(v)
        h = rms_norm(h, p["norm_f"], cfg.norm_eps)
        head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        logits = h @ head
        cache["pos"] = pos + 1
        return logits, cache
