"""repro_torch's model zoo against repro's: configs, the building blocks,
one attention and one dense-block decode step, and Model.decode_step end
to end (full cache, ring buffer, bf16) from the reference's own
parameters carried across by params_from_reference. Inputs are numpy
arrays from a seed, handed to both packages."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import layers as jlayers
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.interop import (cache_from_reference,
                                 model_config_from_reference,
                                 params_from_reference)
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import layers as tlayers
from repro_torch.models.model import Model as TModel

ARCH = "glm4-9b"
#: f32 matmuls over d_model = 256 and 24 steps of decoding, summed in
#: another order on each side
ATOL = RTOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    ref = dataclasses.asdict(jget_config(ARCH, reduced=reduced))
    port = get_config(ARCH, reduced=reduced)
    assert dataclasses.asdict(port) == ref
    assert model_config_from_reference(ref) == port
    assert port.head_dim == jget_config(ARCH, reduced=reduced).head_dim


def test_config_registry_and_shapes():
    from repro.configs.base import SHAPES as JSHAPES
    from repro.configs import ARCHS as JARCHS
    assert ARCHS == JARCHS and len(ARCHS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-x")
    assert {k: dataclasses.asdict(v) for k, v in TSHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    cfg = get_config(ARCH, reduced=True).with_sliding_window(8)
    assert cfg.sliding_window == 8
    with pytest.raises(ValueError, match="unknown"):
        model_config_from_reference({**dataclasses.asdict(cfg), "warp": 9})


def test_full_width_shapes_without_allocating():
    """Every parameter of the full glm4-9b built on the meta device has the
    reference's path and shape (jax.eval_shape of Model.init, the layer
    stack on its leading L axis), 12 leaves and 9.40 B parameters in all."""
    cfg = get_config(ARCH)
    ref = jax.eval_shape(JModel(jget_config(ARCH)).init,
                         jax.random.PRNGKey(0))
    want = {".".join(p.key for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    model = TModel(cfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want and len(got) == 12
    assert all(p.is_meta and p.dtype == torch.bfloat16
               for p in model.parameters())
    total = sum(p.numel() for p in model.parameters())
    assert round(total / 1e9, 2) == 9.40


def test_other_families_are_not_ported():
    """Every family of the reference builds: moe, hybrid and ssm (their
    parity is in tests/test_torch_moe.py, test_torch_hybrid.py,
    test_torch_xlstm.py), vlm and audio (tests/test_torch_archs*.py); a
    family the reference does not have is refused."""
    for arch, family in (("qwen3-moe-30b-a3b", "moe"),
                         ("zamba2-7b", "hybrid"), ("xlstm-125m", "ssm"),
                         ("llava-next-mistral-7b", "vlm"),
                         ("musicgen-medium", "audio")):
        model = TModel(get_config(arch, reduced=True), device="cpu")
        assert model.cfg.family == family and len(model.params()) >= 4
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), family="cnn")
    with pytest.raises(ValueError, match="unknown family"):
        TModel(cfg, device="cpu")


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_swiglu(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    wg, wu = (rng.standard_normal((64, 96)).astype(np.float32) / 8
              for _ in range(2))
    wd = rng.standard_normal((96, 64)).astype(np.float32) / 8
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7

    def both(jfn, tfn, *arrays):
        j = jfn(*(jnp.asarray(a).astype(jdt) for a in arrays))
        t = tfn(*(_t(a).to(tdt) for a in arrays))
        assert t.dtype == tdt
        np.testing.assert_allclose(t.to(torch.float32).numpy(),
                                   np.asarray(j, np.float32), atol=tol,
                                   rtol=tol)

    both(lambda a, b: jlayers.rms_norm(a, b, 1e-5),
         lambda a, b: tlayers.rms_norm(a, b, 1e-5), x, w)
    both(jlayers.swiglu, tlayers.swiglu, x, wg, wu, wd)


@pytest.mark.parametrize("d_head", [64, 128])
def test_apply_rope(d_head):
    """Positions up to 32,767 (the decode_32k cache): the frequencies are
    bit-equal, cos/sin of the same f32 angles differ by an ulp."""
    rng = np.random.default_rng(d_head)
    pos = np.concatenate([np.arange(0, 32768, 509), [32767]]) \
        .astype(np.int32)[None]                               # (1, S)
    x = rng.standard_normal((1, pos.shape[1], 2, d_head)).astype(np.float32)
    np.testing.assert_array_equal(
        tlayers.rope_frequencies(d_head).numpy(),
        np.asarray(jlayers.rope_frequencies(d_head)))
    j = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos))
    t = tlayers.apply_rope(_t(x), torch.from_numpy(pos))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=2e-6,
                               rtol=1e-5)


# ---------------------------------------------- one attention / block step

def _one_layer(cfg, seed):
    """The reference's one-layer dense block params and a cache with 5
    slots filled, as numpy."""
    p = _np(jblocks.dense_block_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    p["norm1"] = (1 + 0.1 * rng.standard_normal(cfg.d_model)) \
        .astype(np.float32)
    shape = (2, 16, cfg.n_kv_heads, cfg.head_dim)
    cache = {"k": np.zeros(shape, np.float32),
             "v": np.zeros(shape, np.float32)}
    cache["k"][:, :5] = rng.standard_normal(shape)[:, :5]
    cache["v"][:, :5] = rng.standard_normal(shape)[:, :5]
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    return p, cache, x


def _block(p, cfg):
    """One layer's parameters as the model reads them: layer 0 of a
    one-layer stack."""
    stack = jax.tree_util.tree_map(lambda a: _t(a)[None], p)
    return tblocks.layer_view(stack, 0)


def test_attn_decode_one_step():
    cfg = get_config(ARCH, reduced=True)
    p, cache, x = _one_layer(cfg, seed=1)
    pos = 5
    jout, jcache = jattn.attn_decode(
        p["attn"], jnp.asarray(x), {k: jnp.asarray(a) for k, a in
                                    cache.items()},
        jnp.asarray(pos, jnp.int32), cfg)
    tcache = {k: _t(a) for k, a in cache.items()}
    with torch.no_grad():
        tout, tcache2 = tattn.attn_decode(_block(p, cfg).attn, _t(x), tcache,
                                          pos, cfg)
    assert tcache2 is tcache                       # written in place
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                               atol=ATOL, rtol=RTOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5,
                                   rtol=1e-5)


def test_dense_block_decode_one_step():
    cfg = get_config(ARCH, reduced=True)
    p, cache, x = _one_layer(cfg, seed=2)
    pos = 5
    jout, jcache = jblocks.dense_block_decode(
        p, jnp.asarray(x), {k: jnp.asarray(a) for k, a in cache.items()},
        jnp.asarray(pos, jnp.int32), cfg)
    tcache = {k: _t(a) for k, a in cache.items()}
    with torch.no_grad():
        tout, _ = tblocks.dense_block_decode(_block(p, cfg), _t(x), tcache,
                                             pos, cfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               atol=1e-5, rtol=1e-5)


# ------------------------------------------------------ decode end to end

def _decode_both(cfg, steps, max_len, B=2, seed=0):
    """Both models from the reference's Model.init, from an empty cache;
    each step feeds both the reference's greedy token (the first one drawn
    from the seed). Yields (step, ref logits, port logits, ref cache,
    port cache) as numpy/torch."""
    jm = JModel(cfg)
    jparams = jm.init(jax.random.PRNGKey(seed))
    tm = params_from_reference(_np(jparams), cfg, device="cpu")
    jcache = jm.init_cache(B, max_len)
    tcache = cache_from_reference(_np(jcache), device="cpu")
    assert tcache["pos"] == 0
    step = jax.jit(jm.decode_step)
    tok = np.random.default_rng(seed).integers(0, cfg.vocab, (B, 1))
    for t in range(steps):
        jlogits, jcache = step(jparams, jcache,
                               {"tokens": jnp.asarray(tok, jnp.int32)})
        tlogits, tcache = tm.decode_step(tcache,
                                         {"tokens": torch.tensor(tok)})
        yield t, np.asarray(jlogits, np.float32), tlogits, jcache, tcache
        tok = np.asarray(jnp.argmax(jlogits, axis=-1))


def _check_decode(cfg, steps, max_len, atol, rtol):
    for t, jl, tl, jc, tc in _decode_both(cfg, steps, max_len):
        assert tl.shape == jl.shape and tc["pos"] == t + 1
        np.testing.assert_allclose(tl.to(torch.float32).numpy(), jl,
                                   atol=atol, rtol=rtol,
                                   err_msg=f"logits, step {t}")
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), jl.argmax(-1),
                                      err_msg=f"greedy token, step {t}")
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["attn"][key].to(torch.float32).numpy(),
                                   np.asarray(jc["attn"][key], np.float32),
                                   atol=atol, rtol=rtol)
    assert int(jc["pos"]) == tc["pos"] == steps


def test_decode_step_matches_reference():
    """The reduced glm4-9b in f32, B = 2, 24 steps from an empty cache."""
    _check_decode(get_config(ARCH, reduced=True), 24, 32, ATOL, RTOL)


def test_decode_step_ring_buffer():
    """Sliding window 8 over 20 steps: the cache is a ring buffer of 8
    slots and the slot wraps twice."""
    cfg = get_config(ARCH, reduced=True).with_sliding_window(8)
    assert TModel(cfg, device="meta").init_cache(2, 64)["attn"]["k"] \
        .shape[2] == 8
    _check_decode(cfg, 20, 64, ATOL, RTOL)


def test_decode_step_bf16():
    """The reduced glm4-9b in bf16 on both sides, 12 steps. Every matmul
    output and every norm, RoPE and residual is rounded to bf16 (2^-8
    relative) in the two frameworks at slightly different places, and the
    port's attention keeps p in f32 where the reference rounds it (see
    test_torch_kernels.py::test_bf16_probability_rounding_difference).
    Logits of size ~1 then agree to a few bf16 ulps: atol = rtol = 2^-5
    (4 ulps at 1.0); the greedy tokens agree."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              dtype="bfloat16")
    _check_decode(cfg, 12, 16, 2.0 ** -5, 2.0 ** -5)


# ------------------------------------------------------------------ interop

def test_params_from_reference_rejects_a_wrong_tree():
    cfg = get_config(ARCH, reduced=True)
    tree = _np(JModel(cfg).init(jax.random.PRNGKey(0)))
    model = params_from_reference(tree, cfg, device="cpu")
    np.testing.assert_array_equal(tblocks.layer_view(model.params()["layers"], 1)
                                  .attn.w_q.detach().numpy(),
                                  tree["layers"]["attn"]["w_q"][1])
    missing = {k: v for k, v in tree.items() if k != "lm_head"}
    with pytest.raises(ValueError, match="missing.*lm_head"):
        params_from_reference(missing, cfg, device="cpu")
    extra = {**tree, "projector": np.zeros((4, 4), np.float32)}
    with pytest.raises(ValueError, match="not in the port's model.*projector"):
        params_from_reference(extra, cfg, device="cpu")
    wrong = {**tree, "norm_f": np.ones(cfg.d_model + 1, np.float32)}
    with pytest.raises(ValueError, match="norm_f: shape"):
        params_from_reference(wrong, cfg, device="cpu")
    short = {**tree, "layers": {**tree["layers"],
                                "norm1": tree["layers"]["norm1"][:1]}}
    with pytest.raises(ValueError, match="leading axis"):
        params_from_reference(short, cfg, device="cpu")
