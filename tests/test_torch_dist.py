"""The port's sharding rules and the trainers' mesh checks, in one process
with no process group: ``repro_torch.models.sharding`` (``param_spec``,
``data_spec``, ``cache_spec``, ``explain_specs``) and
``repro_torch.dist.collectives.tree_machine_specs`` against the
reference's ``repro.models.sharding`` and ``repro.dist.collectives`` on
every leaf of all ten configs at full width, and the refusals of meshes
that would shard a payload dim (ROADMAP A12).

The reference's shapes come from ``jax.eval_shape`` of its ``Model.init``
and ``init_cache``, the port's from ``Model(cfg, device="meta")``; the
meshes are ``jax.sharding.AbstractMesh`` (no devices) for the reference
and the same ``{axis name: size}`` mapping for the port. Rank runs are in
tests/test_torch_dist_ranks.py. Specs are compared exactly.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jget_config
from repro.dist import collectives as jcoll
from repro.models import sharding as jshd
from repro.models.model import Model as JModel
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import transport
from repro_torch.dist import collectives as tcoll
from repro_torch.models import sharding as tshd
from repro_torch.models.model import Model
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer

MESHES = {"data16-model16": {"data": 16, "model": 16},
          "pod2-data16-model16": {"pod": 2, "data": 16, "model": 16},
          "machines4": {"machines": 4}}
#: the decode cache the rules are read at: a batch that divides the data
#: axis, and a short sequence (shapes only)
CACHE_B, CACHE_S = 16, 64


def _jmesh(axes):
    return AbstractMesh(tuple(axes.values()), tuple(axes))


def _jpath(kp):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """(reference params, port params, reference cache, port cache) at
    full width, abstract on both sides."""
    jm = JModel(jget_config(arch))
    jp = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jc = jax.eval_shape(lambda: jm.init_cache(CACHE_B, CACHE_S))
    tm = Model(get_config(arch), device="meta")
    return jp, tm.params(), jc, tm.init_cache(CACHE_B, CACHE_S)


def _by_path(tree, specs):
    return dict(zip(transport.leaf_paths(tree),
                    transport.tree_leaves_like(specs, tree)))


def _ref_specs(tree, fn):
    out = {}
    jax.tree_util.tree_map_with_path(
        lambda kp, x: out.__setitem__(_jpath(kp), fn(kp, x)), tree)
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_machine_specs_match_reference(arch, mesh):
    """Every leaf's parameter spec (fsdp off and on), the machine-stacked
    tree's specs (``tree_machine_specs``, fsdp off and on) and the
    ``explain_specs`` table equal the reference's."""
    axes = MESHES[mesh]
    jmesh = _jmesh(axes)
    jp, tp, _, _ = _shapes(arch)
    for fsdp in (False, True):
        want = _ref_specs(jp, lambda kp, x: tuple(jshd.param_spec(
            tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in kp),
            tuple(x.shape), jmesh, fsdp=fsdp)))
        got = _by_path(tp, tshd.param_shardings(tp, axes, fsdp=fsdp))
        assert got == want
        stacked_j = jax.tree_util.tree_map(
            lambda x: jax.ShapeDtypeStruct((4,) + x.shape, x.dtype), jp)
        want = _ref_specs(jcoll.tree_machine_specs(stacked_j, jmesh,
                                                   fsdp=fsdp),
                          lambda kp, s: tuple(s))
        stacked_t = transport.tree_map(
            lambda x: torch.empty((4,) + tuple(x.shape), device="meta"), tp)
        got = _by_path(stacked_t, tcoll.tree_machine_specs(
            stacked_t, axes, fsdp=fsdp))
        assert got == want
    assert tshd.explain_specs(tp, axes) == jshd.explain_specs(jp, jmesh)


@pytest.mark.parametrize("kv_mode", ["auto", "seq", "replicate"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, kv_mode):
    """Every decode-cache leaf's spec on the three meshes (``pos``, the
    port's Python int, a scalar)."""
    _, _, jc, tc = _shapes(arch)
    for axes in MESHES.values():
        jmesh = _jmesh(axes)
        want = _ref_specs(jc, lambda kp, x: tuple(jshd.cache_spec(
            tuple(str(getattr(k, "key", getattr(k, "idx", ""))) for k in kp),
            tuple(x.shape), jmesh, kv_mode=kv_mode)))
        got = _by_path(tc, tshd.cache_shardings(tc, axes, kv_mode=kv_mode))
        assert got == want


@pytest.mark.parametrize("mesh", MESHES)
def test_data_specs_match_reference(mesh):
    """Batch specs over the shapes the catalogue's batches take (ids,
    audio codebooks, vlm patches) at batch sizes that divide and do not."""
    axes = MESHES[mesh]
    jmesh = _jmesh(axes)
    for shape in [(256, 4096), (8, 128), (1, 16), (24, 32, 4), (48, 576,
                                                               1024), (3,)]:
        for bdim in range(len(shape)):
            assert tshd.data_spec(shape, axes, bdim) == tuple(
                jshd.data_spec(shape, jmesh, bdim)), (shape, bdim)
    assert tshd.batch_axes(axes) == jshd.batch_axes(jmesh)
    batch = {"tokens": torch.empty((32, 16), device="meta"),
             "labels": torch.empty((32, 16), device="meta")}
    assert tshd.batch_shardings(batch, axes) == {
        k: tuple(jshd.data_spec((32, 16), jmesh)) for k in batch}


def test_mesh_shape_reads_a_mapping_or_a_device_mesh():
    class Mesh:                        # a DeviceMesh's two attributes
        mesh_dim_names = ("machines",)
        shape = (3,)
    assert tshd.mesh_shape(Mesh()) == {"machines": 3}
    assert tshd.mesh_shape({"data": 2}) == {"data": 2}
    Mesh.mesh_dim_names = None
    with pytest.raises(ValueError, match="named"):
        tshd.mesh_shape(Mesh())
    assert tshd.format_spec((None, ("pod", "data"), "model")) == str(
        jax.sharding.PartitionSpec(None, ("pod", "data"), "model"))


@pytest.fixture(scope="module")
def small_model():
    return Model(get_config("glm4-9b", reduced=True), device="meta")


@pytest.mark.parametrize("mesh,fsdp", [
    ({"data": 16, "model": 16}, False),
    ({"pod": 2, "data": 16, "model": 16}, False),
    ({"data": 2, "machines": 2}, False),
    ({"data": 4}, True),               # fsdp over the machine axis itself
])
def test_payload_sharding_is_refused_naming_a12(small_model, mesh, fsdp):
    """A mesh or fsdp that would shard a payload dim is ROADMAP A12 in
    both trainers (the mesh is read before any process group is)."""
    with pytest.raises(NotImplementedError, match="A12"):
        ttrainer.make_train_step(small_model, topt.AdamW(),
                                 ttrainer.TrainConfig(fsdp=fsdp), mesh=mesh)
    if not fsdp:
        with pytest.raises(NotImplementedError, match="A12"):
            ttrainer.QNTrainer(small_model, ttrainer.QNTrainConfig(),
                               mesh=mesh)


def test_sharded_strategy_holds_non_coordinatewise_rules():
    """The geometric median couples coordinates: a payload-sharded spec is
    refused, as the reference refuses it; replicated payloads pass."""
    from repro_torch.dist.grad_agg import GradAggConfig
    cfg = GradAggConfig(method="geomedian", strategy="sharded")
    with pytest.raises(ValueError, match="coordinate-wise"):
        tcoll.check_spec(cfg, ("machines", "model"))
    tcoll.check_spec(cfg, ("machines", None))
    tcoll.check_spec(GradAggConfig(method="dcq"), ("machines", "model"))
    with pytest.raises(ValueError, match="unknown aggregation"):
        tcoll.check_spec(GradAggConfig(method="nope"), ("machines",))
    # the reference's registry says the same of every rule
    from repro.agg import get_aggregator as jget
    from repro_torch.agg import get_aggregator, registered
    for name in registered():
        assert get_aggregator(name).coordinatewise == \
            jget(name).coordinatewise, name


def test_machine_mesh_exits_as_the_reference_does(monkeypatch, capsys):
    """``--machines`` that does not divide over the ranks exits with the
    reference's message; a ``cuda`` world of more ranks than cards exits
    2 before any group starts (NCCL needs a card per rank)."""
    import torch.distributed as dist

    from repro_torch.launch import cli
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(SystemExit, match="--machines 3 does not divide "
                       "over 2 devices"):
        cli.machine_mesh(3, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as exc:
        cli.machine_mesh(4, "cuda")
    assert exc.value.code == 2
    assert "NCCL needs a card per rank" in capsys.readouterr().err
