"""``repro_torch.configs.shapes`` and the machine model's counts against
the reference: ``adapt_config`` and ``input_specs`` for every one of the
ten archs at the four shapes (names, shapes and dtypes; for decode the
cache's k, v and state leaves), ``concrete_batch``, and
``launch.roofline``'s ``count_params`` and ``model_flops`` at full size
(the reference's from ``jax.eval_shape``, the port's from the meta
device), exactly; and ``launch.mesh``'s production and host meshes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import shapes as jshapes
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jroofline
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs import shapes as tshapes
from repro_torch.core.transport import tree_leaves
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as troofline

CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _dt(x) -> str:
    return str(np.dtype(x.dtype)) if not isinstance(x, torch.Tensor) \
        else str(x.dtype).replace("torch.", "")


def _arrays(tree):
    """(shape, dtype) of every array leaf of a cache, sorted (the two
    packages nest their caches alike but name ``pos`` differently)."""
    return sorted((tuple(x.shape), _dt(x)) for x in tree if
                  hasattr(x, "shape") and len(x.shape) >= 2)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_reference(arch, shape):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jshape, tshape = JSHAPES[shape], SHAPES[shape]
    assert dataclasses.asdict(tshapes.adapt_config(tcfg, tshape)) == \
        dataclasses.asdict(jshapes.adapt_config(jcfg, jshape))
    want, got = jshapes.input_specs(jcfg, jshape), \
        tshapes.input_specs(tcfg, tshape)
    assert list(got) == list(want)
    for name, spec in want.items():
        if name == "cache":
            continue
        assert got[name].device.type == "meta"
        assert tuple(got[name].shape) == tuple(spec.shape), name
        assert _dt(got[name]) == _dt(spec), name
    if tshape.kind == "decode":
        cache = got["cache"]
        assert cache["pos"] == 0
        assert _arrays(tree_leaves(cache)) == \
            _arrays(jax.tree_util.tree_leaves(want["cache"]))
        assert all(t.device.type == "meta" for t in tree_leaves(cache)
                   if isinstance(t, torch.Tensor))
    if shape == "long_500k" and tcfg.family != "ssm":
        win = tshapes.adapt_config(tcfg, tshape).sliding_window
        assert win == (tcfg.sliding_window or tshapes.LONG_WINDOW)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_match_reference(arch, monkeypatch):
    jcfg, tcfg = jget_config(arch), get_config(arch)
    want = jroofline.count_params(jcfg)
    assert troofline.count_params(tcfg) == want
    # the reference's model_flops reads its count_params: traced once here
    monkeypatch.setattr(jroofline, "count_params", lambda cfg: want)
    for name in SHAPES:
        assert troofline.model_flops(tcfg, SHAPES[name]) == \
            jroofline.model_flops(jcfg, JSHAPES[name]), name


@pytest.mark.parametrize("shape", list(SHAPES))
def test_concrete_batch_follows_the_specs(shape):
    cfg = get_config("musicgen-medium", reduced=True)
    small = dataclasses.replace(SHAPES[shape], global_batch=2, seq_len=24)
    specs = tshapes.input_specs(cfg, small)
    a = tshapes.concrete_batch(torch.Generator().manual_seed(1), cfg, small)
    b = tshapes.concrete_batch(torch.Generator().manual_seed(1), cfg, small)
    assert list(a) == list(specs)
    for name, spec in specs.items():
        if name == "cache":
            assert _arrays(tree_leaves(a[name])) == \
                _arrays(tree_leaves(spec))
            assert all(bool((t == 0).all()) for t in tree_leaves(a[name])
                       if isinstance(t, torch.Tensor))
            continue
        assert a[name].shape == spec.shape and a[name].dtype == spec.dtype
        assert a[name].device.type == "cpu"
        assert torch.equal(a[name], b[name])
        assert int(a[name].min()) >= 0 and int(a[name].max()) < cfg.vocab


def test_production_and_host_meshes():
    assert tmesh.make_production_mesh() == {"data": 32, "model": 8}
    assert tmesh.make_production_mesh(multi_pod=True) == \
        {"pod": 2, "data": 32, "model": 8}
    assert (tmesh.PEAK_FLOPS_BF16, tmesh.HBM_BW, tmesh.NVLINK_BW,
            tmesh.IB_BW) == (989e12, 3.35e12, 450e9, 50e9)
    import torch.distributed as dist
    from repro_torch.launch.cli import sharded_run
    with sharded_run(None, "cpu", True):
        host = tmesh.make_host_mesh(device="cpu")
        assert host.mesh_dim_names == ("data", "model")
        assert tuple(host.shape) == (dist.get_world_size(), 1)
        with pytest.raises(ValueError, match="does not divide"):
            tmesh.make_host_mesh(model=2, device="cpu")
        machines = tmesh.make_machine_mesh(1, device="cpu")
        assert machines.mesh_dim_names == ("machines",)
    assert not dist.is_initialized()
