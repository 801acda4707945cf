"""repro_torch's hybrid family (``zamba2-7b``: Mamba2 layers plus one
shared attention block) against the JAX reference on the CPU: the SSD
chunked scan and the Mamba2 mixer at S = 67 (not a multiple of the chunk
32) against the reference and against the sequential oracle
``ssm_reference``, the mixer's gradient (the mask goes on before ``exp``),
its decode step; the reduced model (f32) end to end through the shared
checks of tests/torch_zoo_parity.py, a four-layer model with a shared
block after every second layer (two insertions, two attention caches);
and the full width's head dim, 112, which the decode kernel B2 takes:
a reduced hybrid at head dim 112 decodes as the reference's. Every
reference result is built once per module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo_parity as zoo
from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.interop import cache_from_reference, params_from_reference
from repro_torch.kernels import gqa_decode
from repro_torch.models import blocks
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model
from test_torch_qn import ref_knots  # noqa: F401
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ARCH = "zamba2-7b"
F32_LEAVES = ("a_log", "dt_bias", "d_skip")
XB, XS = 2, 67


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def mixer():
    """The reference's Mamba2 parameters (a_log, dt_bias and d_skip moved
    off their constant init, so every leaf matters), an input of 67
    tokens, and its outputs: ssd_chunked on the projected inputs,
    ssm_forward, ssm_reference, the decode steps and jax.grad of the
    output's sum."""
    cfg = jget_config(ARCH, reduced=True)
    p = jax.tree_util.tree_map(np.asarray,
                               jssm.ssm_init(jax.random.PRNGKey(3), cfg))
    rng = np.random.default_rng(4)
    H = p["a_log"].shape[0]
    p["dt_bias"] = (0.3 * rng.standard_normal(H)).astype(np.float32)
    p["d_skip"] = (1 + 0.2 * rng.standard_normal(H)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)) \
        .astype(np.float32)
    x = (0.1 * rng.standard_normal((XB, XS, cfg.d_model))).astype(np.float32)
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    ssd_in = {"x": rng.standard_normal((XB, XS, H, s.headdim)),
              "dt": np.log1p(np.exp(rng.standard_normal((XB, XS, H)))),
              "B": rng.standard_normal((XB, XS, s.n_groups, s.d_state)),
              "C": rng.standard_normal((XB, XS, s.n_groups, s.d_state))}
    ssd_in = {k: (0.5 * v).astype(np.float32) for k, v in ssd_in.items()}
    assert d_inner // s.headdim == H
    jx = jnp.asarray(x)
    out = {"p": p, "x": x, "ssd_in": ssd_in}
    out["ssd"] = np.asarray(jssm.ssd_chunked(
        *(jnp.asarray(ssd_in[k]) for k in ("x", "dt")),
        jnp.asarray(p["a_log"]),
        *(jnp.asarray(ssd_in[k]) for k in ("B", "C")), cfg))
    out["forward"] = np.asarray(jax.jit(
        lambda pp, v: jssm.ssm_forward(pp, v, cfg))(p, jx))
    step = jax.jit(lambda pp, v, c: jssm.ssm_decode(pp, v, c, cfg))
    cache, ys = jssm.ssm_cache_init(cfg, XB), []
    for t in range(XS):
        y, cache = step(p, jx[:, t:t + 1], cache)
        ys.append(np.asarray(y))
    out["decode"] = np.concatenate(ys, axis=1)
    out["decode_cache"] = jax.tree_util.tree_map(np.asarray, cache)
    out["grad"] = jax.tree_util.tree_map(np.asarray, jax.grad(
        lambda pp, v: (jssm.ssm_forward(pp, v, cfg) ** 2).sum())(p, jx))
    return out


@pytest.fixture(scope="module")
def ref():
    return zoo.reference_run(ARCH)


@pytest.fixture(scope="module", params=["median", "dcq_mad"])
def qn(request):
    return zoo.reference_qn_run(ARCH, request.param)


def _view(p, grad=False):
    leaves = {k: _t(v).requires_grad_(grad) for k, v in p.items()}
    return leaves, blocks.tree_view(leaves)


# ---------------------------------------------------------------- the mixer

def test_ssd_chunked_matches_reference(mixer):
    """67 tokens in chunks of 32 (29 padded), every head, one group."""
    cfg = get_config(ARCH, reduced=True)
    i = mixer["ssd_in"]
    got = tssm.ssd_chunked(_t(i["x"]), _t(i["dt"]), _t(mixer["p"]["a_log"]),
                           _t(i["B"]), _t(i["C"]), cfg)
    np.testing.assert_allclose(got.numpy(), mixer["ssd"], atol=1e-5,
                               rtol=1e-5)


def test_ssm_forward_matches_reference_and_the_recurrence(mixer):
    """The chunked mixer against the reference's, and against the
    sequential oracle ``ssm_reference`` (the reference's
    test_ssd_chunked_equals_recurrence, atol 1e-5)."""
    cfg = get_config(ARCH, reduced=True)
    _, p = _view(mixer["p"])
    x = _t(mixer["x"])
    with torch.no_grad():
        got = tssm.ssm_forward(p, x, cfg)
        seq = tssm.ssm_reference(p, x, cfg)
    np.testing.assert_allclose(got.numpy(), mixer["forward"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=1e-5)


def test_ssm_decode_matches_reference(mixer):
    """The O(1) update step by step, its output and its f32 state and
    conv window."""
    cfg = get_config(ARCH, reduced=True)
    _, p = _view(mixer["p"])
    x = _t(mixer["x"])
    cache, ys = tssm.ssm_cache_init(cfg, XB), []
    with torch.no_grad():
        for t in range(XS):
            y, cache = tssm.ssm_decode(p, x[:, t:t + 1], cache, cfg)
            ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), mixer["decode"],
                               atol=1e-5, rtol=1e-5)
    for k, v in mixer["decode_cache"].items():
        assert cache[k].dtype == torch.float32
        np.testing.assert_allclose(cache[k].numpy(), v, atol=1e-5,
                                   rtol=1e-5)


def test_ssm_gradient_is_finite_and_matches_reference(mixer):
    """The SSD masks the causal segment sums before ``exp``: masked
    entries are exp(-inf) = 0 with a zero gradient. Masking after ``exp``
    would make them inf, and inf x 0 is NaN in the backward pass. The
    gradient of sum(y^2) per leaf within 1e-4 of its largest magnitude."""
    cfg = get_config(ARCH, reduced=True)
    leaves, p = _view(mixer["p"], grad=True)
    (tssm.ssm_forward(p, _t(mixer["x"]), cfg) ** 2).sum().backward()
    for k, t in leaves.items():
        g = mixer["grad"][k]
        assert torch.isfinite(t.grad).all(), k
        err = np.abs(t.grad.numpy() - g).max() / np.abs(g).max()
        assert err <= 1e-4, (k, err)


# ---------------------------------------------------------------- model

def test_forward_and_loss_match_reference(ref):
    zoo.check_forward_and_loss(ref)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(ref, remat):
    zoo.check_gradients(ref, remat)


def test_prefill_and_decode_match_reference(ref):
    zoo.check_prefill_and_decode(ref)


def test_bf16_decode_matches_reference(ref):
    zoo.check_bf16_decode(ref)


def test_params_from_reference_keeps_paths_order_and_dtypes(ref):
    """20 leaves: stacked ``layers/{norm, ssm/...}`` and the unstacked
    ``shared_attn``; a_log, dt_bias and d_skip stay f32 in bf16."""
    zoo.check_interop(ref, F32_LEAVES)
    model = zoo.port_model(ref)
    paths = zoo.transport.leaf_paths(model.params())
    assert len(paths) == 20 and "shared_attn/attn/w_q" in paths
    assert model.params()["layers"]["ssm"]["a_log"].shape[0] == 2
    assert model.params()["shared_attn"]["attn"]["w_q"].dim() == 2


def test_qn_step_matches_reference(ref, qn, ref_knots):
    zoo.check_qn_steps(ref, qn)


def test_shared_block_every_second_layer():
    """Four mamba layers with the shared block after layers 1 and 3: two
    insertions, each with its own attention cache (j = i // 2), the same
    weights at both. Forward and 10 decode steps against the reference
    at atol = rtol = 1e-4."""
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), n_layers=4,
                               attn_every=2)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), n_layers=4,
                              attn_every=2)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    model = params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, device="cpu")
    assert model.n_shared == 2
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 10)) \
        .astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = model.forward({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jc = jm.init_cache(2, 10)
    tc = cache_from_reference(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    assert tuple(tc["attn"]["k"].shape[:2]) == (2, 2)
    step = jax.jit(jm.decode_step)
    for t in range(10):
        jlog, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tlog, tc = model.decode_step(
            tc, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4)
    for key in ("k", "v"):
        np.testing.assert_allclose(tc["attn"][key].numpy(),
                                   np.asarray(jc["attn"][key]), atol=1e-4,
                                   rtol=1e-4)


# ------------------------------------------------ the full width's head dim

def test_head_dim_112_decodes_as_the_reference():
    """zamba2-7b at full width has head_dim 3584 / 32 = 112, which B2 takes
    (its plain version here): a reduced hybrid of d_model 224 and 2 heads
    (head dim 112), the reference's own parameters, forward and 10 decode
    steps against the reference at atol = rtol = 1e-4, its attention
    cache too. A head dim B2 does not take (96) still raises on the
    wrapper's shape check, before it picks the kernel or the plain
    version, so a decode never falls back."""
    assert get_config(ARCH).head_dim == 112
    assert 112 in gqa_decode.HEAD_DIMS
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True), d_model=224,
                               n_heads=2, n_kv_heads=2)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), d_model=224,
                              n_heads=2, n_kv_heads=2)
    assert cfg.head_dim == jcfg.head_dim == 112
    jm = JModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(7))
    model = params_from_reference(jax.tree_util.tree_map(np.asarray, jp),
                                  cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 10)) \
        .astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, _ = model.forward({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jc = jm.init_cache(2, 10)
    tc = model.init_cache(2, 10)
    assert tuple(tc["attn"]["k"].shape) == (model.n_shared, 2, 10, 2, 112)
    step = jax.jit(jm.decode_step)
    for t in range(10):
        jlog, jc = step(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tlog, tc = model.decode_step(
            tc, {"tokens": torch.from_numpy(toks[:, t:t + 1]).long()})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tc["attn"]["v"].numpy(),
                               np.asarray(jc["attn"]["v"]), atol=1e-4,
                               rtol=1e-4)
    odd = Model(dataclasses.replace(cfg, d_model=192), device="cpu")
    assert odd.cfg.head_dim == 96 and 96 not in gqa_decode.HEAD_DIMS
    with pytest.raises(ValueError, match="Dh in"):
        odd.decode_step(odd.init_cache(1, 4),
                        {"tokens": torch.zeros((1, 1), dtype=torch.long)})
