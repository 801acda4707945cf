"""Every architecture of the catalogue in repro_torch against the JAX
reference on the CPU, as tests/test_archs.py runs the reference's: the ten
configs (full and reduced, ``dataclasses.asdict``), the assignment's
numbers and the reduced bounds, the full-width trees on the meta device
against ``jax.eval_shape`` of the reference's ``Model.init``, the LM
batches of every family (the audio family's codebook tokens, the vlm's
f32 patch embeddings, kept float by ``interop.batch_from_numpy``), and the
reduced models from the reference's own parameters and batch: forward
and loss (the vlm's over its text positions only). Gradients, decode and
the AdamW step are in tests/test_torch_archs_{grad,decode,train}.py."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_arch_parity as par
from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.data import lm as jlm
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import transport
from repro_torch.data import lm as tlm
from repro_torch.interop import batch_from_numpy, model_config_from_reference
from repro_torch.models.model import VISION_DIM, Model
from torch_threads import share_the_cores  # noqa: F401 (autouse)

#: tests/test_archs.py's assignment: (layers, d_model, heads, kv heads,
#: d_ff, vocab)
SPEC = {
    "mistral-large-123b": (88, 12288, 96, 8, 28672, 32768),
    "musicgen-medium": (48, 1536, 24, 24, 6144, 2048),
    "zamba2-7b": (81, 3584, 32, 32, 14336, 32000),
    "qwen3-moe-30b-a3b": (48, 2048, 32, 4, 768, 151936),
    "llava-next-mistral-7b": (32, 4096, 32, 8, 14336, 32000),
    "xlstm-125m": (12, 768, 4, 4, 0, 50304),
    "phi3.5-moe-42b-a6.6b": (32, 4096, 32, 8, 6400, 32064),
    "starcoder2-15b": (40, 6144, 48, 4, 24576, 49152),
    "minitron-8b": (32, 4096, 32, 8, 16384, 256000),
    "glm4-9b": (40, 4096, 32, 2, 13696, 151552),
}


def test_registry_is_the_reference_catalogue():
    assert ARCHS == JARCHS and len(ARCHS) == 10
    assert {get_config(a).family for a in ARCHS} == \
        {"dense", "vlm", "audio", "moe", "hybrid", "ssm"}
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-x")


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, reduced):
    ref = jget_config(arch, reduced=reduced)
    port = get_config(arch, reduced=reduced)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert model_config_from_reference(dataclasses.asdict(ref)) == port
    assert port.head_dim == ref.head_dim and port.citation == ref.citation


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_matches_assignment(arch):
    cfg = get_config(arch)
    assert cfg.citation
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_ff, cfg.vocab) == SPEC[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_bounds(arch):
    cfg = get_config(arch, reduced=True)
    assert cfg.n_layers <= 2 and cfg.d_model <= 512
    if cfg.moe:
        assert cfg.moe.n_experts <= 4


def _paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_tree_without_allocating(arch):
    """The full config's parameters on the meta device: the reference's
    leaf paths, order, shapes and dtypes (``jax.eval_shape`` of its
    ``Model.init``), so the same count of parameters."""
    ref = jax.eval_shape(JModel(jget_config(arch)).init,
                         jax.random.PRNGKey(0))
    tree = Model(get_config(arch), device="meta").params()
    assert transport.leaf_paths(tree) == _paths(ref)
    got = [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for t in transport.tree_leaves(tree)]
    want = [(tuple(x.shape), str(x.dtype))
            for x in jax.tree_util.tree_leaves(ref)]
    assert got == want
    assert all(t.is_meta for t in transport.tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_has_the_reference_layout(arch):
    """The port's batch of every family has the reference's keys, shapes
    and (after ``batch_from_numpy``) dtypes: (B, S) ids, (B, S, nc) for
    audio (the chain tiled over the codebooks), the vlm's (B, n_patches,
    VISION_DIM) f32 patch embeddings (0.1 x standard normals)."""
    cfg = get_config(arch, reduced=True)
    want = batch_from_numpy(jlm.make_batch(jax.random.PRNGKey(0),
                                           jget_config(arch, reduced=True),
                                           3, 12), "cpu")
    got = tlm.make_batch(torch.Generator().manual_seed(0), cfg, 3, 12)
    assert list(got) == list(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype == want[key].dtype, key
    text = got["tokens"][..., 0] if cfg.family == "audio" else got["tokens"]
    assert torch.equal(text[:, 1:], got["labels"][:, :-1])
    if cfg.family == "audio":
        assert got["tokens"].shape[-1] == cfg.n_codebooks
        assert (got["tokens"] == got["tokens"][..., :1]).all()
    if cfg.family == "vlm":
        pe = got["patch_embeds"]
        assert pe.shape == (3, cfg.n_patches, VISION_DIM)
        assert 0.08 < float(pe.std()) < 0.12


def test_batch_from_numpy_keeps_patch_embeds_float():
    cfg = jget_config("llava-next-mistral-7b", reduced=True)
    ref = jax.tree_util.tree_map(np.asarray,
                                 jlm.make_batch(jax.random.PRNGKey(2), cfg,
                                                2, 8))
    assert ref["patch_embeds"].dtype == np.float32
    got = batch_from_numpy({**ref, "mask": np.ones((2, 8), np.int32)},
                           "cpu")
    assert got["tokens"].dtype == got["labels"].dtype == torch.int64
    assert got["mask"].dtype == got["patch_embeds"].dtype == torch.float32
    np.testing.assert_array_equal(got["patch_embeds"].numpy(),
                                  ref["patch_embeds"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch):
    """Logits (the vlm's over patches and text), the aux loss, the cross
    entropy and the loss at atol = rtol = 1e-4."""
    ref = par.reference_inputs(arch)
    want = par.reference_forward(arch)
    model = par.port_model(ref)
    batch = par.port_batch(ref)
    with torch.no_grad():
        logits, aux = model.forward(batch)
        loss, parts = model.loss(batch)
    np.testing.assert_allclose(logits.numpy(), want["logits"], atol=par.ATOL,
                               rtol=par.RTOL)
    for key, got in (("aux", aux), ("ce", parts["ce"]), ("loss", loss)):
        np.testing.assert_allclose(got.item(), want[key], atol=par.ATOL,
                                   rtol=par.RTOL)


def test_vlm_loss_scores_only_the_text_positions():
    """The vlm's logits cover patches then text; its loss is the cross
    entropy of the text positions alone (the patches have no target),
    so it does not move when the patch positions' logits are changed,
    and equals the reference's."""
    ref = par.reference_inputs("llava-next-mistral-7b")
    model = par.port_model(ref)
    batch = par.port_batch(ref)
    n_patch = batch["patch_embeds"].shape[1]
    with torch.no_grad():
        logits, _ = model.forward(batch)
        loss, parts = model.loss(batch)
    assert logits.shape[1] == n_patch + batch["tokens"].shape[1]
    text = torch.nn.functional.cross_entropy(
        logits[:, n_patch:].reshape(-1, logits.shape[-1]),
        batch["labels"].reshape(-1))
    np.testing.assert_allclose(parts["ce"].item(), text.item(), rtol=1e-6)
    np.testing.assert_allclose(loss.item(),
                               par.reference_forward(
                                   "llava-next-mistral-7b")["loss"],
                               atol=par.ATOL,
                               rtol=par.RTOL)
    # without patches the model is a text-only dense model
    with torch.no_grad():
        bare, _ = model.forward({"tokens": batch["tokens"]})
    assert bare.shape[1] == batch["tokens"].shape[1]


def test_audio_embedding_sums_the_codebooks():
    """The audio family's embedding of (B, S, nc) tokens is the sum of the
    nc codebook tables' rows, codebook 0 first."""
    ref = par.reference_inputs("musicgen-medium")
    model = par.port_model(ref)
    toks = par.tokens(ref["batch"]["tokens"])
    assert toks.shape[-1] == model.cfg.n_codebooks == model.embed.shape[0]
    distinct = toks.clone()
    distinct[..., 1] = (distinct[..., 1] + 5) % model.cfg.vocab
    with torch.no_grad():
        h = model._embed(model.params(), {"tokens": distinct})
    want = sum(model.embed[c].detach()[distinct[..., c]]
               for c in range(model.cfg.n_codebooks))
    torch.testing.assert_close(h, want, atol=0, rtol=0)
