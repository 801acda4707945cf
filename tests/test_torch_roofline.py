"""``repro_torch.launch.roofline``'s counting mode on the CPU: the FLOPs of
a reduced glm4-9b train step, prefill and decode traced on the meta
device equal ``FlopCounterMode`` around the same step on CPU tensors
(bf16, where the CPU's SDPA takes its flash op and the trace the fused
op, both by the GQA formula; B2's plain twin silenced on the CPU, as the
card's launch is invisible to ``FlopCounterMode``); the hand kernels'
meta rules (shape and dtype, nothing computed, no launch counted; CPU
calls unchanged); ``decide`` on meta; bytes, live bytes and collective
bytes; and ``analyze``'s terms. Counts are compared exactly."""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.shapes import concrete_batch
from repro_torch.launch import dryrun, roofline
from torch_threads import share_the_cores  # noqa: F401 (autouse)

CFG = dataclasses.replace(get_config("glm4-9b", reduced=True),
                          dtype="bfloat16")
SMALL = {kind: ShapeConfig(f"small_{kind}", 32, 4, kind)
         for kind in ("train", "prefill", "decode")}


@pytest.fixture
def small_shapes(monkeypatch):
    for shape in SMALL.values():
        monkeypatch.setitem(SHAPES, shape.name, shape)


def _cpu_step(kind, monkeypatch):
    """FlopCounterMode's count around the step on CPU tensors."""
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainConfig, make_train_step
    monkeypatch.setattr(gqa, "gqa_decode_plain",
                        lambda q, k, v, n: torch.zeros_like(q))
    shape = SMALL[kind]
    model = Model(CFG, device="cpu", remat=True)
    g = torch.Generator().manual_seed(0)
    batch = concrete_batch(g, CFG, shape)
    with FlopCounterMode(display=False,
                         custom_mapping=roofline.SDPA_FORMULAS) as fc:
        if kind == "train":
            opt = AdamW(lr=1e-4)
            step = make_train_step(model, opt, TrainConfig(
                n_machines=2, agg=GradAggConfig(method="dcq",
                                                dp_sigma=1e-5)))
            params = model.params()
            step(params, opt.init(params), batch, g)
        elif kind == "prefill":
            with torch.no_grad():
                model.forward(batch)[0][:, -1]
        else:
            cache = batch["cache"]
            cache["pos"] = shape.seq_len - 1
            model.decode_step(cache, {"tokens": batch["tokens"]})
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_traced_flops_equal_flop_counter_on_cpu(kind, small_shapes,
                                                monkeypatch):
    counts, *_ = dryrun.trace_one("glm4-9b", SMALL[kind].name,
                                  cfg_override=CFG,
                                  mesh={"data": 1, "model": 1},
                                  n_machines=2)
    assert counts.flops > 0
    assert counts.flops == _cpu_step(kind, monkeypatch)
    if kind == "decode":
        assert dict(counts.launches) == {"gqa_decode": CFG.n_layers}
    if kind == "train":
        assert dict(counts.launches) == {"ostat": 12}
    assert counts.peak > 0 and counts.bytes > 0


def test_kernel_meta_rules_compute_nothing():
    from repro_torch.agg import kernel as b1
    from repro_torch.kernels import gqa_decode as b2
    before = (b1.launches, b2.launches)
    v = torch.empty((3, 4, 50), dtype=torch.bfloat16, device="meta")
    out = b1.ostat(v, "dcq_mad")
    assert out.shape == (3, 50) and out.dtype == torch.bfloat16
    assert out.device.type == "meta"
    trip = b1.ostat(v, "median_mad_dcq")
    assert [t.shape for t in trip] == [(3, 50)] * 3
    q = torch.empty((2, 32, 128), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 64, 2, 128), dtype=torch.bfloat16, device="meta")
    n = torch.empty((2,), dtype=torch.int32, device="meta")
    o = b2.gqa_decode(q, k, k, n)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert (b1.launches, b2.launches) == before
    with roofline.CountingMode() as cm:
        b1.ostat(v, "dcq_mad")
        b2.gqa_decode(q, k, k, n)
    # B1 reads its f32 widening (3 x 4 x 50 x 4) and writes (3, 50) f32;
    # B2 reads q, k, v and writes the output
    assert cm.kernel_bytes["ostat"] == 3 * 4 * 50 * 4 + 3 * 50 * 4
    assert cm.kernel_bytes["gqa_decode"] == 2 * (2 * (2 * 32 * 128)
                                                 + 2 * (2 * 64 * 2 * 128))
    assert dict(cm.launches) == {"ostat": 1, "gqa_decode": 1}
    # CPU tensors still take the plain twins
    x = torch.randn(3, 4, 50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(b1.ostat(x, "median"), b1.ostat_plain(x, "median"))
    qc = torch.randn(2, 4, 64)
    kc = torch.randn(2, 8, 2, 64)
    nc = torch.tensor([8, 3], dtype=torch.int32)
    assert torch.equal(b2.gqa_decode(qc, kc, kc, nc),
                       b2.gqa_decode_plain(qc, kc, kc, nc))
    with pytest.raises(RuntimeError, match="meta-device trace op"):
        b1.ostat_trace(x.reshape(3, 4, 50), 1)


def test_meta_gets_the_cards_dispatch_decision():
    from repro_torch.agg import dispatch
    a = dispatch.decide("dcq_mad", 1, 4, 1000, "meta")
    b = dispatch.decide("dcq_mad", 1, 4, 1000, "cuda")
    assert a == b and a.backend == "kernel"
    before = dispatch.decisions()
    dispatch.decide("dcq_mad", 1, 4, 1000, "meta")
    assert dispatch.decisions() == before      # a trace decides nothing


def test_bytes_live_bytes_and_collectives_are_counted():
    from repro_torch.dist.collectives import MeshAxis
    x = torch.empty((1024, 256), device="meta")
    with roofline.CountingMode().track(x) as cm:
        assert cm.live == x.numel() * 4
        y = x * 2                        # reads x, writes y
        z = y.t()                        # a view: nothing moved
        assert cm.bytes == 2 * x.numel() * 4
        assert cm.peak == 2 * x.numel() * 4
        del y, z
        assert cm.live == x.numel() * 4
        g = MeshAxis("model", 8).all_gather(x[:128], 0)
        MeshAxis("data", 4).all_reduce(x)
        assert g.shape == (1024, 256)
    coll = cm.collective_bytes()
    assert coll["all-gather"] == coll["nvlink"] == 1024 * 256 * 4
    assert coll["all-reduce"] == coll["ib"] == 1024 * 256 * 4
    assert MeshAxis("model", 1).all_gather(x, 0) is x


def test_analyze_prices_each_link_and_picks_the_dominant_term():
    from repro_torch.launch import mesh as meshmod
    cm = roofline.CountingMode()
    cm.flops, cm.bytes = int(989e12), int(3.35e12 * 2)
    cm.record_collective("all-gather", "model", int(450e9))
    cm.record_collective("all-gather", "data", int(50e9 * 4))
    cfg, shape = get_config("glm4-9b"), SHAPES["train_4k"]
    rep = roofline.analyze(cm, cfg, shape, "32x8", 256, "glm4-9b")
    assert rep.compute_s == pytest.approx(1.0)
    assert rep.memory_s == pytest.approx(2.0)
    assert rep.collective_nvlink_s == pytest.approx(1.0)
    assert rep.collective_ib_s == pytest.approx(4.0)
    assert rep.collective_s == pytest.approx(5.0)
    assert rep.dominant == "collective"
    assert rep.model_flops == roofline.model_flops(cfg, shape)
    assert rep.useful_ratio == pytest.approx(rep.model_flops
                                             / (989e12 * 256))
    assert meshmod.PEAK_FLOPS_BF16 == 989e12


def test_meta_attention_is_one_fused_op():
    from repro_torch.models import flash
    q = torch.empty((1, 64, 8, 64), dtype=torch.bfloat16, device="meta")
    k = torch.empty((1, 64, 2, 64), dtype=torch.bfloat16, device="meta")
    with roofline.CountingMode() as cm:
        out = flash.flash_attention(q, k, k)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert cm.flops == 2 * (2 * 8 * 64 * 64 * 64)
    # no (S, S) scores: the largest output is the attention's own
    assert cm.peak < 4 * q.numel() * 2 + 8 * 64 * 4 * 4


def test_qn_step_traces_with_every_machine_pushing():
    """The QN step traced on meta: its curvature test reads a meta tensor
    on the host, which the counting mode reads as ones, so every machine
    pushes (B1 once a leaf in each of the five rounds); outside the mode
    that read fails, since a meta tensor holds nothing."""
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.configs.shapes import input_specs
    from repro_torch.models.model import Model
    from repro_torch.train.trainer import QNTrainConfig, make_qn_train_step
    cfg = get_config("glm4-9b", reduced=True)
    model = Model(cfg, device="meta", remat=True)
    step = make_qn_train_step(model, QNTrainConfig(
        n_machines=2, protocol=TreeProtocolConfig(hist=2)),
        {"data": 1, "model": 1})
    params = model.params()
    from repro_torch.core.bfgs import LBFGSMemory
    mem = LBFGSMemory.init_like(2, params, machines=2)
    batch = input_specs(cfg, SMALL["train"])
    with roofline.CountingMode().track(params, mem, batch) as cm:
        _, mem, metrics = step(params, mem, batch)
    n_leaves = len(list(roofline.tensors_of(params)))
    assert dict(cm.launches) == {"ostat": 5 * n_leaves}
    assert cm.flops > 0 and metrics["loss"].is_meta
    with pytest.raises(NotImplementedError, match="meta"):
        step(params, mem, batch)
