"""Every architecture of the catalogue in repro_torch against the JAX
reference on the CPU: ``torch.autograd`` of the reduced model's loss
against ``jax.grad`` of the reference's, from its own parameters and batch
(tests/torch_arch_parity.py), leaf for leaf."""
import numpy as np
import pytest

import torch_arch_parity as par
from repro_torch.configs import ARCHS
from repro_torch.core import transport
from torch_threads import share_the_cores  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_grad(arch):
    """``torch.autograd`` of the loss against ``jax.grad``, leaf for leaf
    (the audio's stacked codebook embedding and the vlm's projector among
    them), within 1e-4 of each leaf's largest magnitude."""
    ref = par.reference_inputs(arch)
    model = par.port_model(ref)
    loss, _ = model.loss(par.port_batch(ref))
    loss.backward()
    paths = transport.leaf_paths(model.params())
    want = transport.tree_leaves(par.reference_grads(arch))
    assert len(paths) == len(want)
    for path, p, g in zip(paths, transport.tree_leaves(model.params()),
                          want):
        assert tuple(p.grad.shape) == g.shape, path
        scale = max(float(np.abs(g).max()), 1e-30)
        err = float(np.abs(p.grad.numpy() - g).max()) / scale
        assert err <= 1e-4, (path, err)
