"""Every architecture of the catalogue in repro_torch against the JAX
reference on the CPU: one AdamW step of ``Trainer`` (M machines of one
row each, the median, machine 0 signflipped, no noise) against the
reference's ``Trainer``, from its own parameters and batch
(tests/torch_arch_parity.py)."""
import numpy as np
import pytest
import torch

import torch_arch_parity as par
from repro_torch.configs import ARCHS
from repro_torch.core import transport
from repro_torch.dist import grad_agg as tga
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from torch_threads import share_the_cores  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_step_matches_reference(arch):
    """One ``Trainer`` step: the loss and grad norm at rtol 1e-4, the
    parameters within 1e-5 on 99.99% of the coordinates and within 2 x lr
    on all (AdamW's first step moves each coordinate by about lr, and its
    sign is that of a median of four machine gradients summed in another
    order)."""
    ref = par.reference_inputs(arch)
    want = par.reference_train_step(arch)
    model = par.port_model(ref)
    tcfg = ttrainer.TrainConfig(n_machines=par.M, agg=tga.GradAggConfig(
        method="median", attack="signflip"))
    trainer = ttrainer.Trainer(model, topt.AdamW(lr=par.LR), tcfg)
    metrics = []
    params, state, _ = trainer.fit(
        model.params(), [par.port_batch(ref)],
        byz_mask=torch.arange(par.M) < 1,
        callback=lambda i, m: metrics.append(
            (m["loss"].item(), m["grad_norm"].item())))
    assert state.step == 1
    np.testing.assert_allclose(np.array(metrics), np.array(want["metrics"]),
                               rtol=1e-4)
    got = [t.detach().numpy() for t in transport.tree_leaves(params)]
    ref_p = [np.asarray(x) for x in transport.tree_leaves(want["params"])]
    assert [a.shape for a in got] == [b.shape for b in ref_p]
    close = sum(int(np.isclose(a, b, atol=1e-5, rtol=0).sum())
                for a, b in zip(got, ref_p))
    total = sum(a.size for a in got)
    assert close >= 0.9999 * total, f"{total - close} of {total} apart"
    for a, b in zip(got, ref_p):
        assert np.abs(a - b).max() <= 2 * par.LR


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "musicgen-medium"])
def test_new_families_through_the_sweep_and_checkpoints(arch, tmp_path):
    """The vlm and audio families through the sweep's ``TrainScenario``
    (two AdamW steps on the CPU: finite losses) and the checkpoint: the
    port's file of the reference's parameters holds the reference's keys
    (the audio's (nc, V, d) ``params/embed``, the vlm's
    ``params/projector``) with the bytes of the reference's own file, and
    the reference restores it equal."""
    import jax
    from repro.checkpoint import checkpoint as jckpt
    from repro_torch import sweep as tsweep
    from repro_torch.checkpoint import checkpoint as tckpt
    from repro_torch.sweep.executor import SweepExecutor
    s = tsweep.TrainScenario(arch=arch, steps=2, batch=8, seq=16,
                             machines=4)
    rec = SweepExecutor(device="cpu").run([s])["scenarios"][s.scenario_id()]
    assert len(rec["metrics"]["losses"]) == 2
    assert all(np.isfinite(rec["metrics"]["losses"]))
    ref = par.reference_inputs(arch)
    model = par.port_model(ref)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jckpt.save(jpath, ref["params"], step=3, meta={"arch": arch})
    tckpt.save(tpath, model.params(), step=3, meta={"arch": arch})
    key = ("params/embed" if arch == "musicgen-medium"
           else "params/projector")
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files) and key in b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    q, _, step, _ = jckpt.restore(tpath, ref["params"])
    assert step == 3
    for x, y in zip(jax.tree_util.tree_leaves(q),
                    jax.tree_util.tree_leaves(ref["params"])):
        np.testing.assert_array_equal(np.asarray(x), y)
