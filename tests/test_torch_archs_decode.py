"""Every architecture of the catalogue in repro_torch against the JAX
reference on the CPU: STEPS decode steps from an empty cache (the audio
family's (B, 1, n_codebooks) tokens; the vlm drops its patch embeddings,
as the reference does) against the reference's ``decode_step``, from its
own parameters and batch (tests/torch_arch_parity.py)."""
import numpy as np
import pytest
import torch

import torch_arch_parity as par
from repro_torch.configs import ARCHS
from torch_threads import share_the_cores  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """f32 logits of every step at atol = rtol = 1e-4, the cache's
    position advanced once a step."""
    ref = par.reference_inputs(arch)
    want = par.reference_decode(arch)
    model = par.port_model(ref)
    toks = ref["batch"]["tokens"]
    cache = model.init_cache(par.B, par.STEPS)
    out = []
    for t in range(par.STEPS):
        batch = {"tokens": par.tokens(toks[:, t:t + 1])}
        if model.cfg.family == "vlm":
            # dropped by decode_step, as the reference drops it
            batch["patch_embeds"] = torch.zeros((par.B, 3, 1024))
        lg, cache = model.decode_step(cache, batch)
        assert lg.shape == (par.B, 1, model.cfg.vocab)
        out.append(lg.numpy())
    assert cache["pos"] == par.STEPS
    np.testing.assert_allclose(np.concatenate(out, axis=1), want,
                               atol=par.ATOL, rtol=par.RTOL)
