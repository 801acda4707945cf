"""repro_torch's MoE family (``qwen3-moe-30b-a3b``) against the JAX
reference on the CPU: ``moe_ffn``'s output and its three router stats
(aux loss, dropped fraction, load fraction) at the reduced config's
capacity, at capacity_factor 0.25 (the reference's
test_moe_capacity_overflow_drops_not_corrupts), on a batch of repeated
tokens (a non-stable sort would drop other assignments), over two
dispatch shards, and its gradient; then the reduced model (f32) end to
end through the shared checks of tests/torch_zoo_parity.py. Routing
weights are normal draws, so no token's router logits tie. Every
reference result is built once per module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo_parity as zoo
from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import blocks
from repro_torch.models import moe as tmoe
from test_torch_qn import ref_knots  # noqa: F401
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ARCH = "qwen3-moe-30b-a3b"
F32_LEAVES = ("w_router",)

#: (name, capacity_factor, dispatch_shards, repeated tokens)
CASES = (("default", None, 1, False), ("overflow", 0.25, 1, False),
         ("repeated", 0.25, 1, True), ("shards", None, 2, False))


def _cfg(get, factor, shards):
    cfg = get(ARCH, reduced=True)
    moe = cfg.moe
    if factor is not None:
        moe = dataclasses.replace(moe, capacity_factor=factor)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(moe, dispatch_shards=shards))


def _input(cfg, repeated, seed=1):
    rng = np.random.default_rng(seed)
    if repeated:          # 8 distinct tokens, each 8 times, interleaved
        base = rng.standard_normal((8, cfg.d_model))
        x = np.tile(base, (8, 1))[None]
    else:
        x = rng.standard_normal((2, 32, cfg.d_model))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def ffn():
    """The reference's moe_ffn output, stats and gradient per case."""
    p = jax.tree_util.tree_map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(0), jget_config(ARCH, reduced=True)))
    out = {"p": p}
    for name, factor, shards, repeated in CASES:
        cfg = _cfg(jget_config, factor, shards)
        x = _input(cfg, repeated)
        y, stats = jax.jit(lambda pp, v, c=cfg: jmoe.moe_ffn(pp, v, c))(
            p, jnp.asarray(x))
        grad = jax.grad(lambda pp, v, c=cfg: (
            jmoe.moe_ffn(pp, v, c)[0] ** 2).sum()
            + jmoe.moe_ffn(pp, v, c)[1]["aux_loss"])(p, jnp.asarray(x))
        out[name] = {"x": x, "y": np.asarray(y),
                     "stats": jax.tree_util.tree_map(np.asarray, stats),
                     "grad": jax.tree_util.tree_map(np.asarray, grad)}
    return out


@pytest.fixture(scope="module")
def ref():
    return zoo.reference_run(ARCH)


@pytest.fixture(scope="module", params=["median", "dcq_mad"])
def qn(request):
    return zoo.reference_qn_run(ARCH, request.param)


def _leaves(p, grad=False):
    return {k: torch.tensor(v).requires_grad_(grad) for k, v in p.items()}


# ------------------------------------------------------------------ the FFN

@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_and_stats_match_reference(ffn, case):
    name, factor, shards, _ = case
    want = ffn[name]
    cfg = _cfg(get_config, factor, shards)
    with torch.no_grad():
        y, stats = tmoe.moe_ffn(blocks.tree_view(_leaves(ffn["p"])),
                                torch.tensor(want["x"]), cfg)
    # outputs of size ~100 (unit-normal inputs, 1/sqrt(E)-scaled experts)
    np.testing.assert_allclose(y.numpy(), want["y"], atol=1e-4, rtol=1e-4)
    assert set(stats) == {"aux_loss", "dropped_frac", "load_frac"}
    for k, v in want["stats"].items():
        np.testing.assert_allclose(stats[k].numpy(), v, atol=1e-6,
                                   rtol=1e-6, err_msg=k)
    if factor is not None:        # capacity overflow drops, not corrupts
        assert stats["dropped_frac"].item() > 0
        assert torch.isfinite(y).all()
    np.testing.assert_allclose(stats["load_frac"].sum().item(), 1.0,
                               atol=1e-6)


def test_repeated_tokens_need_the_stable_sort(ffn, monkeypatch):
    """With 8 copies of each token, many assignments share an expert id;
    the rank within an expert (token order, the stable sort's) decides
    which go over capacity. A sort that breaks ties the other way (the
    later assignment first) drops other assignments and gives another
    output."""
    want = ffn["repeated"]
    cfg = _cfg(get_config, 0.25, 1)
    x = torch.tensor(want["x"])
    p = blocks.tree_view(_leaves(ffn["p"]))
    with torch.no_grad():
        y, stats = tmoe.moe_ffn(p, x, cfg)
        real = torch.argsort

        def later_first(t, stable=False):
            n = t.numel()
            return real(t * n + (n - 1 - torch.arange(n)), stable=True)
        monkeypatch.setattr(torch, "argsort", later_first)
        y_rev, stats_rev = tmoe.moe_ffn(p, x, cfg)
    np.testing.assert_allclose(y.numpy(), want["y"], atol=1e-4, rtol=1e-4)
    assert stats["dropped_frac"].item() > 0
    assert stats_rev["dropped_frac"].item() == stats["dropped_frac"].item()
    assert not np.allclose(y_rev.numpy(), want["y"], atol=1e-2)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_moe_ffn_gradient_matches_reference(ffn, case):
    """``jax.grad`` of sum(y^2) + aux through the dispatch, the capacity
    drops and the unsort, per leaf within 1e-4 of its largest
    magnitude."""
    name, factor, shards, _ = case
    cfg = _cfg(get_config, factor, shards)
    leaves = _leaves(ffn["p"], grad=True)
    y, stats = tmoe.moe_ffn(blocks.tree_view(leaves),
                            torch.tensor(ffn[name]["x"]), cfg)
    ((y ** 2).sum() + stats["aux_loss"]).backward()
    for k, t in leaves.items():
        g = ffn[name]["grad"][k]
        err = np.abs(t.grad.numpy() - g).max() / np.abs(g).max()
        assert err <= 1e-4, (k, err)


def test_capacity_matches_reference():
    for factor in (None, 0.25, 2.0):
        for tokens in (1, 8, 64, 4096):
            assert tmoe.moe_capacity(_cfg(get_config, factor, 1), tokens) \
                == jmoe.moe_capacity(_cfg(jget_config, factor, 1), tokens)
    full = get_config(ARCH)
    assert tmoe.moe_capacity(full, 4096) == \
        jmoe.moe_capacity(jget_config(ARCH), 4096) == 321


# ---------------------------------------------------------------- model

def test_forward_and_loss_match_reference(ref):
    """The loss is the cross entropy plus 0.01 x the aux loss summed over
    the layers."""
    zoo.check_forward_and_loss(ref)
    assert ref["aux"] > 0
    np.testing.assert_allclose(ref["loss"], ref["ce"] + 0.01 * ref["aux"],
                               rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_reference(ref, remat):
    zoo.check_gradients(ref, remat)


def test_prefill_and_decode_match_reference(ref):
    zoo.check_prefill_and_decode(ref)


def test_bf16_decode_matches_reference(ref):
    zoo.check_bf16_decode(ref)


def test_params_from_reference_keeps_paths_order_and_dtypes(ref):
    """13 stacked leaves; ``layers/moe/w_router`` stays f32 in bf16."""
    zoo.check_interop(ref, F32_LEAVES)
    paths = zoo.transport.leaf_paths(zoo.port_model(ref).params())
    assert len(paths) == 13 and "layers/moe/w_router" in paths


def test_qn_step_matches_reference(ref, qn, ref_knots):
    zoo.check_qn_steps(ref, qn)
