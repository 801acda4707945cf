"""repro_torch's xLSTM family (the ssm family, ``xlstm-125m``) against the
JAX reference on the CPU: the mLSTM's chunked stabilised form at chunks
16 and 512 (S not a multiple of the chunk) and its decode recurrence,
the sLSTM's scan and decode step, then the reduced model (f32) end to end
through the shared checks of tests/torch_zoo_parity.py: forward and
loss, gradients against ``jax.grad``, prefill against decode, bf16
decode, the parameter tree across, and the quasi-Newton step from the
reference's state. Inputs are numpy arrays from a seed, handed to both
packages; every reference result is built once per module."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_zoo_parity as zoo
from repro.configs import get_config as jget_config
from repro.models import xlstm as jx
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.core import transport
from repro_torch.interop import batch_from_numpy, params_from_reference
from repro_torch.models import blocks
from repro_torch.models import xlstm as tx
from repro_torch.models.model import Model as TModel
from test_torch_qn import ref_knots  # noqa: F401
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ARCH = "xlstm-125m"
#: the leaves the reference keeps in f32 in a bf16 model
F32_LEAVES = ("w_if", "b_if", "r_h", "b")
#: mixer tests: 2 sequences of 40 tokens (40 = 2 x 16 + 8)
MB, MS = 2, 40


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _view(p):
    return blocks.tree_view({k: _t(v) for k, v in p.items()})


@pytest.fixture(scope="module")
def mixers():
    """The reference's mLSTM and sLSTM parameters and an input, and its
    outputs: the chunked mLSTM at chunks 16 and 512, both decode
    recurrences step by step, the sLSTM scan."""
    cfg = jget_config(ARCH, reduced=True)
    pm = jax.tree_util.tree_map(np.asarray,
                                jx.mlstm_init(jax.random.PRNGKey(5), cfg))
    ps = jax.tree_util.tree_map(np.asarray,
                                jx.slstm_init(jax.random.PRNGKey(7), cfg))
    x = (0.5 * np.random.default_rng(6).standard_normal(
        (MB, MS, cfg.d_model))).astype(np.float32)
    jxx = jnp.asarray(x)
    out = {"pm": pm, "ps": ps, "x": x}
    for chunk in (16, 512):
        out[f"mlstm{chunk}"] = np.asarray(jax.jit(
            lambda p, v, c=chunk: jx.mlstm_forward(p, v, cfg, chunk=c))(
                pm, jxx))
    out["slstm"] = np.asarray(jax.jit(
        lambda p, v: jx.slstm_forward(p, v, cfg))(ps, jxx))
    for name, init, dec, p in (("mdec", jx.mlstm_cache_init, jx.mlstm_decode,
                                pm),
                               ("sdec", jx.slstm_cache_init, jx.slstm_decode,
                                ps)):
        step = jax.jit(lambda pp, v, c, d=dec: d(pp, v, c, cfg))
        cache, ys = init(cfg, MB), []
        for t in range(MS):
            y, cache = step(p, jxx[:, t:t + 1], cache)
            ys.append(np.asarray(y))
        out[name] = np.concatenate(ys, axis=1)
        out[name + "_cache"] = jax.tree_util.tree_map(np.asarray, cache)
    return out


@pytest.fixture(scope="module")
def ref():
    return zoo.reference_run(ARCH)


@pytest.fixture(scope="module", params=["median", "dcq_mad"])
def qn(request):
    return zoo.reference_qn_run(ARCH, request.param)


# ---------------------------------------------------------------- mixers

@pytest.mark.parametrize("chunk", [16, 512])
def test_mlstm_forward_matches_reference(mixers, chunk):
    """The chunked form at 40 tokens: chunk 16 pads 8 keys with -1e30
    weights, chunk 512 is one chunk of 40. The port stops each query
    chunk's KV loop at the diagonal, where the reference also scans the
    fully masked chunks (which add exactly zero)."""
    cfg = get_config(ARCH, reduced=True)
    with torch.no_grad():
        got = tx.mlstm_forward(_view(mixers["pm"]), _t(mixers["x"]), cfg,
                               chunk=chunk)
    np.testing.assert_allclose(got.numpy(), mixers[f"mlstm{chunk}"],
                               atol=1e-5, rtol=1e-5)


def test_mlstm_does_not_depend_on_the_chunk(mixers):
    """Chunks 8, 16 and 512 give the same output up to f32 rounding of
    the running max's rescales (the reference's own property)."""
    cfg = get_config(ARCH, reduced=True)
    p, x = _view(mixers["pm"]), _t(mixers["x"])
    with torch.no_grad():
        outs = [tx.mlstm_forward(p, x, cfg, chunk=c) for c in (8, 16, 512)]
    for o in outs[:2]:
        np.testing.assert_allclose(o.numpy(), outs[2].numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_mlstm_decode_matches_reference_and_the_chunked_form(mixers):
    """The O(1) recurrence step by step: against the reference's decode
    (1e-5) and its cache, and against the chunked form (the reference's
    test_mlstm_chunked_equals_recurrence, atol 1e-4)."""
    cfg = get_config(ARCH, reduced=True)
    p, x = _view(mixers["pm"]), _t(mixers["x"])
    cache, ys = tx.mlstm_cache_init(cfg, MB), []
    with torch.no_grad():
        for t in range(MS):
            y, cache = tx.mlstm_decode(p, x[:, t:t + 1], cache, cfg)
            ys.append(y)
    got = torch.cat(ys, dim=1).numpy()
    np.testing.assert_allclose(got, mixers["mdec"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, mixers["mlstm16"], atol=1e-4)
    for k, v in mixers["mdec_cache"].items():
        assert cache[k].dtype == torch.float32
        np.testing.assert_allclose(cache[k].numpy(), v, atol=1e-5,
                                   rtol=1e-5)


def test_slstm_forward_and_decode_match_reference(mixers):
    """The sequential scan (one input projection for the whole sequence,
    then S cell steps) and the decode step, against the reference's scan
    and decode; the two forms agree with each other."""
    cfg = get_config(ARCH, reduced=True)
    p, x = _view(mixers["ps"]), _t(mixers["x"])
    with torch.no_grad():
        full = tx.slstm_forward(p, x, cfg)
        cache, ys = tx.slstm_cache_init(cfg, MB), []
        for t in range(MS):
            y, cache = tx.slstm_decode(p, x[:, t:t + 1], cache, cfg)
            ys.append(y)
    np.testing.assert_allclose(full.numpy(), mixers["slstm"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), mixers["sdec"],
                               atol=1e-5, rtol=1e-5)
    for k, v in mixers["sdec_cache"].items():
        np.testing.assert_allclose(cache[k].numpy(), v, atol=1e-5,
                                   rtol=1e-5)


def test_mlstm_gradient_is_finite_and_matches_reference(mixers):
    """The backward pass through the -1e30 key padding and the running
    max: ``jax.grad`` of the output's sum against the port's, per leaf
    within 1e-4 of the leaf's largest magnitude."""
    cfg = get_config(ARCH, reduced=True)
    jg = jax.grad(lambda p, v: jx.mlstm_forward(p, v, cfg, chunk=16).sum())(
        mixers["pm"], jnp.asarray(mixers["x"]))
    leaves = {k: _t(v).requires_grad_() for k, v in mixers["pm"].items()}
    tx.mlstm_forward(blocks.tree_view(leaves), _t(mixers["x"]), cfg,
                     chunk=16).sum().backward()
    for k, t in leaves.items():
        g = np.asarray(jg[k])
        assert torch.isfinite(t.grad).all()
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
    """17 leaves with list indices (``xlstm_layers/0/mixer/w_q``); the
    mLSTM's w_if/b_if and the sLSTM's r_h/b stay f32 in bf16."""
    zoo.check_interop(ref, F32_LEAVES)
    paths = zoo.transport.leaf_paths(zoo.port_model(ref).params())
    assert len(paths) == 17 and "xlstm_layers/0/mixer/w_q" in paths
    assert "xlstm_layers/1/mixer/r_h" in paths


def test_qn_step_matches_reference(ref, qn, ref_knots):
    zoo.check_qn_steps(ref, qn)


def test_full_depth_gradient_norm_matches_reference(capsys):
    """xlstm-125m at its full depth and layout (12 layers, sLSTM at 1 and
    7) on the reduced width, f32, two rows of 16 tokens: from the
    reference's parameters the port's loss and gradient norm equal
    ``jax.grad``'s (rtol 1e-4); the port's own init has a gradient norm of
    the same order (within 10x). The depth is what makes the norm large
    (~8.6 at 2 layers), and chip_smoke phase 21's step sizes rest on it;
    the full width runs only on the card. Leaf for leaf the gradients
    cannot hold 1e-4 of a leaf's scale at this depth in f32: the
    reference's own gradient moves by ~5e-4 of a leaf's scale when its
    parameters move by one ulp (~7e-6 at 2 layers), so each leaf of the
    port's is held within 4x that move of the reference's."""
    full = get_config(ARCH)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              n_layers=full.n_layers, slstm_at=full.slstm_at)
    jcfg = dataclasses.replace(jget_config(ARCH, reduced=True),
                               n_layers=full.n_layers, slstm_at=full.slstm_at)
    jm = JModel(jcfg)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(3)))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 17)) \
        .astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jgrad = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref_grads(p):
        (loss, _), g = jgrad(p, jb)
        return float(loss), [np.asarray(x) for x in
                             jax.tree_util.tree_leaves(g)]

    def port_grads(model):
        loss, _ = model.loss(batch_from_numpy(batch, "cpu"))
        g = torch.autograd.grad(loss, transport.tree_leaves(model.params()))
        return float(loss.detach()), [x.numpy() for x in g]

    def norm(gs):
        return float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                                 for g in gs)))

    def worst(gs, want):
        return max(float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in zip(gs, want))

    jloss, jgrads = ref_grads(params)
    up = np.random.default_rng(4)
    _, moved = ref_grads(jax.tree_util.tree_map(
        lambda x: np.nextafter(x, np.where(up.random(x.shape) < 0.5, np.inf,
                                           -np.inf).astype(x.dtype)),
        params))
    loss, tgrads = port_grads(params_from_reference(params, cfg,
                                                    device="cpu"))
    own = norm(port_grads(TModel(
        cfg, device="cpu", generator=torch.Generator().manual_seed(3)))[1])
    ulp, gap = worst(moved, jgrads), worst(tgrads, jgrads)
    with capsys.disabled():
        print(f"\nfull-depth xLSTM: gradient norm reference {norm(jgrads)}, "
              f"port {norm(tgrads)}, port's own init {own}; largest gap of "
              f"a leaf, of its scale: port {gap}, reference at one ulp {ulp}")
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    np.testing.assert_allclose(norm(tgrads), norm(jgrads), rtol=1e-4)
    assert len(tgrads) == len(jgrads)
    assert gap <= 4 * ulp
    assert 0.1 <= own / norm(jgrads) <= 10.0
