"""Card-only tests of repro_torch: the CUDA order-statistics and GQA
flash-decode kernels against their plain versions, the protocol slice
and the model's decode step on the card against the CPU, the sweep's
smoke preset on the card, the serving path (B1 at its shapes, the
masked bisect forms, a service on the card against the CPU) and the
training paths (attention, an AdamW and a quasi-Newton step on the card
against the CPU, the launcher), and the model zoo's xLSTM, MoE and hybrid
families (card against CPU, the launcher at its default arch, the
hybrid at head dim 112 card against CPU). Each test decides
inside itself whether a card is present and skips where there is none.
The holds of the card against the CPU run under ``chip_smoke``'s
``platform_rule()`` (B1 at its planner's lanes, as before the measured
table); the other paths count dispatch decisions, every one of them a B1
launch at the lanes the table measured. This file imports neither jax nor
repro, so it
also runs where JAX is not installed:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import EDGE_MS, launch_mark, platform_rule
from repro_torch.agg import kernel
from repro_torch.configs import get_config
from repro_torch.configs.base import ProtocolConfig
from repro_torch.core.losses import get_problem
from repro_torch.core.protocol import DPQNProtocol, transmission_names
from repro_torch.data.synthetic import make_shards
from repro_torch.kernels import gqa_decode as gqa
from repro_torch.models.model import Model

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU form")
    return torch.device("cuda")


def _since(mark):
    """(B1 launches, decisions for the kernel, dispatch decisions) since
    ``mark`` (``chip_smoke.launch_mark``)."""
    return tuple(a - b for a, b in zip(launch_mark(), mark))


def _p999_rel(got, ref):
    """99.9th percentile of |err| / max(1, |ref|) (CQ knot ties flip
    single indicators, so the sum-based ops are gated on it)."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    return float(np.quantile(np.abs(got - ref) / np.maximum(1.0, np.abs(ref)),
                             0.999))


@pytest.mark.parametrize("op", kernel.OPS)
def test_kernel_matches_plain_version(cuda, op):
    g = torch.Generator(device=cuda).manual_seed(0)
    # ragged p, odd and even m, an m whose slab exceeds shared memory, and
    # the Newton baseline's p^2 = 100-coordinate Hessian median
    for shape in ((320, 8, 10), (20, 51, 10), (1, 8, 4099), (2, 1000, 130),
                  (1, 51, 100)):
        v = torch.randn(shape, generator=g, device=cuda)
        sc = torch.rand((shape[0], shape[2]), generator=g, device=cuda) + 0.1
        sc = sc if op == "dcq" else None
        before = kernel.launches
        got = kernel.ostat(v, op, sc, kth=2)
        assert kernel.launches == before + 1
        ref = kernel.ostat_plain(v, op, sc, kth=2)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(got, ref):
            if op in ("kth", "median"):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
            else:
                assert _p999_rel(a, b) <= 1e-5


@pytest.mark.parametrize("m", EDGE_MS)
@pytest.mark.parametrize("op", kernel.OPS)
def test_kernel_at_the_group_edges(cuda, op, m):
    """Each op at the group edges, with a ragged p and B > 1 (3 x m x 13)
    and at a card-filling p (1 x m x 20000 where that stays small):
    kth/median bit-equal to the plain version, the rest at the p99.9
    gate, one launch per call."""
    g = torch.Generator(device=cuda).manual_seed(m)
    shapes = [(3, m, 13)] + ([(1, m, 20000)] if m <= 81 else [])
    for shape in shapes:
        v = torch.randn(shape, generator=g, device=cuda)
        sc = torch.rand((shape[0], shape[2]), generator=g, device=cuda) + 0.1
        sc = sc if op == "dcq" else None
        kw = dict(kth=m // 3, trim_beta=0.2 if m >= 3 else 0.0)
        before = kernel.launches
        got = kernel.ostat(v, op, sc, **kw)
        assert kernel.launches == before + 1
        ref = kernel.ostat_plain(v, op, sc, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip(got, ref):
            assert bool(torch.isfinite(a).all())
            if op in ("kth", "median"):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
            else:
                assert _p999_rel(a, b) <= 1e-5


SMALL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)


def _small_views(g, m, dtype, cuda):
    """The small-m path's layouts at m rows: a ragged p with B > 1, an
    aligned p with B > 1, and a view whose data starts one element into
    its buffer."""
    odd = torch.randn(1 + 2 * m * 1000, generator=g, device=cuda) \
        .to(dtype)[1:].view(2, m, 1000)
    return [torch.randn((3, m, 13), generator=g, device=cuda).to(dtype),
            torch.randn((2, m, 4096), generator=g, device=cuda).to(dtype),
            odd]


@pytest.mark.parametrize("dtype", SMALL_DTYPES, ids=str)
@pytest.mark.parametrize("m", range(1, 9))
def test_small_m_path_matches_plain_version(cuda, m, dtype):
    """At m <= 8 the selection ops read the rows in their own dtype and
    write the result in it: kth, median and the triple's median and MAD
    bit-equal to the plain version, dcq and dcq_mad at the p99.9 gate;
    one launch a call, counted by the path's host counters."""
    g = torch.Generator(device=cuda).manual_seed(100 + m)
    for v in _small_views(g, m, dtype, cuda):
        nb, p = v.shape[0], v.shape[-1]
        sc = torch.rand((nb, p), generator=g, device=cuda) + 0.1
        for op in kernel.SMALL_OPS:
            s = sc if op == "dcq" else None
            before, small = kernel.launches, kernel.small_m_counts()
            got = kernel.ostat(v, op, s, kth=m // 3)
            after = kernel.small_m_counts()
            assert kernel.launches == before + 1
            assert after["launches"] == small["launches"] + 1
            assert after["coords"] == small["coords"] + nb * p
            ref = kernel.ostat_plain(v, op, s, kth=m // 3)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for i, (a, b) in enumerate(zip(got, ref)):
                assert a.dtype == dtype and a.shape == (nb, p)
                if op in ("kth", "median") or i < 2 and len(got) == 3:
                    torch.testing.assert_close(a, b, atol=0, rtol=0)
                else:
                    assert _p999_rel(a, b) <= 1e-5


def _hard_columns(m, seed):
    """(3, m, 40) f32 (as tests/test_torch_agg.py's): ties, constant
    columns, mixed +-0.0 and magnitudes from 1e-30 to 1e30."""
    rng = np.random.default_rng(seed)
    ties = rng.integers(-2, 3, size=(m, 40)).astype(np.float32)
    ties[:, :4] = 1.5
    ties[:, 4:8] = 0.0
    zeros = np.where(rng.random((m, 40)) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[:, ::3] = rng.standard_normal((m, 14)).astype(np.float32) * 1e-30
    wide = (10.0 ** rng.uniform(-30, 30, size=(m, 40))
            * rng.choice([-1.0, 1.0], size=(m, 40))).astype(np.float32)
    return torch.from_numpy(np.stack([ties, zeros, wide]))


@pytest.mark.parametrize("n_bisect", [60, 33, 5, 0])
@pytest.mark.parametrize("m", range(1, 9))
def test_small_m_path_on_hard_columns(cuda, m, n_bisect):
    """The closed forms and the replay on the card: ties, constant
    columns, +-0.0 and 1e-30..1e30, in f32 and bf16-rounded, at trip
    counts down to none: kth at every k, the median and the triple's
    median and MAD bit-equal to the plain version."""
    for v in (_hard_columns(m, m), _hard_columns(m, m).to(torch.bfloat16)
              .float()):
        v = v.to(cuda)
        for k in range(m):
            torch.testing.assert_close(
                kernel.ostat(v, "kth", kth=k, n_bisect=n_bisect),
                kernel.ostat_plain(v, "kth", kth=k, n_bisect=n_bisect),
                atol=0, rtol=0)
        got = kernel.ostat(v, "median_mad_dcq", n_bisect=n_bisect)
        ref = kernel.ostat_plain(v, "median_mad_dcq", n_bisect=n_bisect)
        for a, b in zip(got[:2], ref[:2]):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_small_m_path_allocates_only_its_output(cuda):
    """A bf16 dcq_mad at (4, 2^26) holds no f32 copy of the rows and no
    f32 result: the call's peak is its bf16 output."""
    g = torch.Generator(device=cuda).manual_seed(5)
    v = torch.randn((4, 1 << 26), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    kernel.ostat(v, "dcq_mad")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = kernel.ostat(v, "dcq_mad")
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert out.dtype == torch.bfloat16
    assert grown <= out.numel() * out.element_size() + (1 << 21)


def test_small_m_path_is_one_kernel_named_ostat_kernel(cuda):
    """Under the profiler a small-m call is one kernel on the card, and
    its name holds ``ostat_kernel`` (what the benchmark's B1 readers
    look for): no widening and no cast around it."""
    from torch.profiler import ProfilerActivity, profile
    v = torch.randn((4, 1 << 20), device=cuda, dtype=torch.bfloat16)
    kernel.ostat(v, "dcq_mad")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        kernel.ostat(v, "dcq_mad")
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "ostat_kernel" in names[0], names


def test_small_m_path_counts_its_replays(cuda):
    """The card's counter gains one for each coordinate whose search was
    replayed: a median of (-1, 0, 1) is a zero above the minimum, whose
    sign only the halvings give; normal draws take the closed form."""
    v = torch.randn((1, 3, 100), device=cuda)
    v[0, :, :37] = torch.tensor([-1.0, 0.0, 1.0], device=cuda)[:, None]
    before = kernel.small_m_counts()
    got = kernel.ostat(v, "median")
    after = kernel.small_m_counts()
    torch.testing.assert_close(got, kernel.ostat_plain(v, "median"),
                               atol=0, rtol=0)
    assert after["replayed"] - before["replayed"] == 37
    assert after["coords"] - before["coords"] == 100


@pytest.mark.parametrize("op,shape,dtype", [
    ("mean", (2, 4, 96), torch.bfloat16),
    ("trimmed", (2, 8, 96), torch.float32),
    ("median", (2, 9, 96), torch.bfloat16),
    ("dcq_mad", (2, 4, 96), torch.float64)])
def test_bisection_path_keeps_the_rest(cuda, op, shape, dtype):
    """mean, trimmed, m > 8 and dtypes outside bf16, fp16 and f32 keep the
    bisection path: one launch, nothing counted by the small-m path."""
    v = torch.randn(shape, device=cuda).to(dtype)
    before, small = kernel.launches, kernel.small_m_counts()
    got = kernel.ostat(v, op)
    assert kernel.launches == before + 1
    assert kernel.small_m_counts() == small
    assert got.dtype == dtype
    ref = kernel.ostat_plain(v, op)
    if op == "median":
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    else:
        assert _p999_rel(got, ref) <= 1e-5


def test_kernel_keeps_dtype_and_layout(cuda):
    v = torch.randn((2, 3, 7, 5), device=cuda, dtype=torch.float64)
    out = kernel.ostat(v, "median")
    assert out.dtype == torch.float64 and out.shape == (2, 3, 5)
    torch.testing.assert_close(out, kernel.ostat_plain(v, "median"),
                               atol=0, rtol=0)
    with pytest.raises(ValueError, match="scale on"):
        kernel.ostat(v, "dcq", torch.ones((2, 3, 5), dtype=torch.float64))


def test_slice_on_the_card_matches_the_cpu(cuda):
    m, n, p, reps = 7, 200, 5, 3
    gen = torch.Generator().manual_seed(4)
    X, y = make_shards(gen, "logistic", m, n, p)
    cfg = ProtocolConfig()
    noise = {name: torch.randn((reps, m + 1, p), generator=gen)
             for name in transmission_names(cfg)}
    prob = get_problem("logistic")
    before = kernel.launches
    with platform_rule():
        card = DPQNProtocol(prob, cfg).run_monte_carlo(reps, X, y,
                                                       noise=noise)
    assert kernel.launches == before + 8
    cpu = DPQNProtocol(prob, cfg, device="cpu").run_monte_carlo(
        reps, X, y, noise=noise)
    for f in ("theta_cq", "theta_os", "theta_qn"):
        torch.testing.assert_close(getattr(card, f).cpu(), getattr(cpu, f),
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("op,shape", [("dcq", (20, 51, 10)),
                                      ("median", (20, 51, 10)),
                                      ("dcq_mad", (1, 4, 1 << 20)),
                                      ("mean", (1, 4, 1 << 10))])
def test_dispatch_on_the_card_follows_the_table(cuda, op, shape):
    """``backend=None`` on a CUDA tensor runs the committed table's
    decision for the shape's bucket: one B1 launch at the lanes it
    measured, the same aggregate as the kernel forced at those lanes."""
    from repro_torch.agg import aggregate_batched, dispatch
    dec = dispatch.decide(op, *shape, platform="cuda")
    assert dec.source == "table" and dec.backend == "kernel"
    assert dec.params["lanes"] in kernel.lane_counts(shape[1])
    g = torch.Generator(device=cuda).manual_seed(3)
    v = torch.randn(shape, generator=g, device=cuda)
    sc = torch.rand((shape[0], shape[2]), generator=g, device=cuda) + 0.1 \
        if op == "dcq" else None
    before = kernel.launches
    got = aggregate_batched(v, op, scale=sc)
    assert kernel.launches == before + 1
    assert torch.equal(got, kernel.ostat(v, op, sc, **dec.params))


def test_smoke_sweep_on_the_card_holds_every_launch(cuda, tmp_path,
                                                    monkeypatch):
    """The ``smoke`` preset through the sweep CLI on the card, with every
    kernel launch held against the plain version (kth/median bit-equal,
    the rest at the p99.9 gate): valid artifact, every scenario present,
    finite metrics, 8 dispatch decisions per scenario, each one B1
    launch."""
    import repro_torch.agg as agg
    from repro_torch.sweep import build_preset, cli, load
    real, held = agg.ostat, []

    def ostat_held(values, op, scale=None, **kw):
        got = real(values, op, scale, **kw)
        plain = kernel.ostat_plain(values, op, scale, **kw)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        plain if isinstance(plain, tuple) else (plain,)):
            if op in ("kth", "median"):
                torch.testing.assert_close(a, b, atol=0, rtol=0)
            else:
                assert _p999_rel(a, b) <= 1e-5
        held.append(op)
        return got
    monkeypatch.setattr(agg, "ostat", ostat_held)
    path = str(tmp_path / "smoke.json")
    mark = launch_mark()
    assert cli.main(["--preset", "smoke", "--out", path]) == 0
    scens = build_preset("smoke")
    launches, kern, decided = _since(mark)
    assert launches == len(held) == kern == decided == 8 * len(scens)
    art = load(path)
    assert set(art["scenarios"]) == {s.scenario_id() for s in scens}
    for rec in art["scenarios"].values():
        assert rec["timing"]["launches"] == 8
        assert all(np.isfinite(v) for v in rec["metrics"].values())
    assert art["meta"]["device"] == torch.cuda.get_device_name(0)


# ------------------------------------------------------ GQA flash-decode

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv,Dh", [
    (2, 128, 8, 2, 64), (3, 96, 4, 4, 128), (1, 1024, 16, 2, 128),
    (4, 33, 8, 1, 64), (2, 4096, 32, 2, 128), (2, 300, 6, 2, 64),
    (2, 700, 16, 4, 64), (1, 200, 16, 8, 128), (2, 150, 6, 3, 64),
    # chunks of 512 slots: the bf16 pass's ring of 64-slot stages wraps
    (1, 32768, 32, 2, 128)])
def test_gqa_decode_matches_plain_version(cuda, dtype, B, S, Hq, Hkv, Dh):
    """f32 at the JAX kernel test's tolerance; bf16 to one bf16 rounding of
    the output (both round the same f32 function once, summed in another
    order). Slots past cache_len hold NaN, which must not leak."""
    g = torch.Generator(device=cuda).manual_seed(S + Hq)
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    clen = torch.randint(1, S + 1, (B,), generator=g, device=cuda,
                         dtype=torch.int32)
    clen[0] = S
    past = torch.arange(S, device=cuda)[None, :] >= clen[:, None]
    k2 = k.masked_fill(past[..., None, None], float("nan"))
    v2 = v.masked_fill(past[..., None, None], float("nan"))
    before = gqa.launches
    got = gqa.gqa_decode(q, k2, v2, clen)
    assert gqa.launches == before + 1
    ref = gqa.gqa_decode_plain(q, k, v, clen)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-6,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("clen", [1, 63, 64, 65, 511, 512, 513, 4096])
def test_gqa_decode_at_chunk_and_tile_edges(cuda, dtype, clen):
    """B = 1 at the main path's heads (Hq = 32, Hkv = 2, Dh = 128), S =
    4,096, with cache_len on the 16-slot tile, the 64-slot block step and
    the 512-slot boundaries and at S; NaN past cache_len must not leak."""
    B, S, Hq, Hkv, Dh = 1, 4096, 32, 2, 128
    g = torch.Generator(device=cuda).manual_seed(clen)
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    cl = torch.full((B,), clen, dtype=torch.int32, device=cuda)
    past = torch.arange(S, device=cuda)[None, :] >= cl[:, None]
    k2 = k.masked_fill(past[..., None, None], float("nan"))
    v2 = v.masked_fill(past[..., None, None], float("nan"))
    before = gqa.launches
    got = gqa.gqa_decode(q, k2, v2, cl)
    assert gqa.launches == before + 1
    ref = gqa.gqa_decode_plain(q, k, v, cl)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-6,
                                   rtol=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Hq,Hkv", [
    (2, 300, 32, 32),          # zamba2-7b's heads, g = 1
    (3, 700, 16, 4),           # g = 4, the last kv head's box past the row
    (1, 200, 24, 2),           # g = 12
    (2, 4096, 8, 8)])
@pytest.mark.parametrize("clen", [1, 15, 16, 17, 63, 64, 65, 200])
def test_gqa_decode_at_head_dim_112(cuda, dtype, B, S, Hq, Hkv, clen):
    """Dh = 112 (zamba2-7b at full width): the bf16 path reads a row as two
    64-column TMA boxes (the second 16 columns into the next kv head, or
    zero fill past the last one), the f32 path and the combine give 28
    lanes 4 dims each. Against the plain version at the tile and block
    edges of cache_len, with NaN past cache_len, which must not leak. bf16
    within one bf16 rounding (rtol 2^-7) and an atol of 2^-16 x max|v|,
    the kernel's documented precision of P (two bf16 parts), which
    chip_smoke's gqa_check_model holds the models' decode shapes to: where
    a head's terms cancel to an output far below max|v|, one rounding of
    the output is less than the f32 sum's own error."""
    Dh = 112
    g = torch.Generator(device=cuda).manual_seed(S + Hq + clen)
    q = torch.randn((B, Hq, Dh), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=cuda).to(dtype)
    cl = torch.full((B,), min(clen, S), dtype=torch.int32, device=cuda)
    cl[-1] = S
    past = torch.arange(S, device=cuda)[None, :] >= cl[:, None]
    k2 = k.masked_fill(past[..., None, None], float("nan"))
    v2 = v.masked_fill(past[..., None, None], float("nan"))
    before = gqa.launches
    got = gqa.gqa_decode(q, k2, v2, cl)
    assert gqa.launches == before + 1
    ref = gqa.gqa_decode_plain(q, k, v, cl)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=2e-5, rtol=1e-4)
    else:
        torch.testing.assert_close(
            got.float(), ref.float(), rtol=2.0 ** -7,
            atol=2.0 ** -16 * v.float().abs().max().item())
        wide = gqa.gqa_decode_plain(q.float(), k.float(), v.float(), cl)
        torch.testing.assert_close(got.float(), wide, atol=0.05, rtol=0.05)


def test_gqa_decode_refuses_a_head_dim_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 96), device=cuda)
    k = torch.zeros((1, 16, 2, 96), device=cuda)
    cl = torch.ones((1,), dtype=torch.int32, device=cuda)
    before = gqa.launches
    with pytest.raises(ValueError, match="Dh in"):
        gqa.gqa_decode(q, k, k, cl)
    assert gqa.launches == before


def test_gqa_decode_plan_on_the_card(cuda):
    """The wrapper's plan at the main shape fits one wave of the card's
    resident split-pass blocks and covers the cache."""
    q = torch.zeros((8, 32, 128), dtype=torch.bfloat16, device=cuda)
    k = torch.zeros((8, 32768, 2, 128), dtype=torch.bfloat16, device=cuda)
    plan = gqa.plan_for(q, k)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert plan.slots % sms == 0 and plan.slots >= sms
    assert plan.waves == 1 and plan.blocks >= 0.9 * plan.slots
    assert plan.n_chunks * plan.chunk >= 32768 and plan.chunk % 64 == 0


def test_decode_step_on_the_card_matches_the_cpu(cuda):
    """The reduced glm4-9b in f32, the same weights on both sides, 12
    greedy steps from an empty cache: one kernel launch per layer and
    step, logits within atol = rtol = 1e-4, the same tokens."""
    cfg = get_config("glm4-9b", reduced=True)
    cpu = Model(cfg, device="cpu",
                generator=torch.Generator().manual_seed(3))
    card = Model(cfg, device=cuda, generator=torch.Generator(cuda))
    card.load_state_dict(cpu.state_dict())
    cc, gc = cpu.init_cache(2, 16), card.init_cache(2, 16)
    tok = torch.tensor([[1], [7]])
    before = gqa.launches
    for _ in range(12):
        lc, cc = cpu.decode_step(cc, {"tokens": tok})
        lg, gc = card.decode_step(gc, {"tokens": tok.to(cuda)})
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1))
        tok = lc.argmax(-1)
    assert gqa.launches == before + 12 * cfg.n_layers


# ------------------------------------------------------- the serving path

@pytest.mark.parametrize("op", ["median", "dcq", "dcq_mad"])
@pytest.mark.parametrize("shape", [(1, 16384, 10), (1, 45, 10),
                                   (1, 4, 1 << 24)])
def test_kernel_at_the_serve_shapes(cuda, op, shape):
    """B1 at the largest fleet, at the launcher's fill and at one column
    block of a full-width leaf: median bit-equal to the plain version,
    the CQ ops at the p99.9 gate."""
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    v = torch.randn(shape, generator=g, device=cuda)
    sc = torch.rand((1, shape[2]), generator=g, device=cuda) + 0.1 \
        if op == "dcq" else None
    before = kernel.launches
    got = kernel.ostat(v, op, sc)
    assert kernel.launches == before + 1
    ref = kernel.ostat_plain(v, op, sc)
    assert bool(torch.isfinite(got).all())
    if op == "median":
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    else:
        assert _p999_rel(got, ref) <= 1e-5


@pytest.mark.parametrize("method", ["median", "dcq_mad", "dcq"])
def test_masked_bisect_on_the_card_reads_only_the_prefix(cuda, method):
    """aggregate_masked on a CUDA buffer launches B1 once and equals the
    same call on the dense prefix byte for byte, with garbage past the
    fill."""
    from repro_torch.agg import aggregate_masked
    g = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn((64, 3, 5), generator=g, device=cuda)
    for k in (1, 17, 44, 64):
        dirty = buf.clone()
        dirty[k:] = 1e30
        scale = 0.7 if method == "dcq" else None
        before = kernel.launches
        a = aggregate_masked(dirty, k, method, scale=scale,
                             backend="bisect")
        assert kernel.launches == before + 1
        b = aggregate_masked(buf[:k].clone(), k, method, scale=scale,
                             backend="bisect")
        assert torch.equal(a, b)
        assert a.shape == (3, 5)


def test_service_on_the_card_matches_the_cpu(cuda):
    """Three rounds (the last partial) of dcq_mad and median with eps = 1
    on CPU-drawn updates and noise: one B1 launch per round on the card;
    dcq_mad thetas within 1e-5, median bit-equal, ledgers equal."""
    from repro_torch.serve import (AggregationService, FlushPolicy,
                                   ServeConfig)
    gen = torch.Generator().manual_seed(5)
    fills = (256, 256, 179)
    ups = [torch.randn((n, 10), generator=gen) for n in fills]
    noise = [torch.randn((256, 10), generator=gen) for _ in fills]
    for rule in ("dcq_mad", "median"):
        cfg = ServeConfig(method=rule, capacity=256, eps=1.0, lr=0.1)
        pol = FlushPolicy(capacity_frac=None)
        card = AggregationService(torch.zeros(10), cfg, pol, device=cuda)
        cpu = AggregationService(torch.zeros(10), cfg, pol, device="cpu")
        before = kernel.launches
        with platform_rule():
            for u, z in zip(ups, noise):
                for svc, x in ((card, u.to(cuda)), (cpu, u)):
                    svc.submit_many(x)
                    svc.flush(noise=z)
        assert kernel.launches == before + len(fills)
        if rule == "median":
            assert torch.equal(card.theta.cpu(), cpu.theta)
        else:
            torch.testing.assert_close(card.theta.cpu(), cpu.theta,
                                       atol=1e-5, rtol=1e-5)
        assert card.ledger == cpu.ledger


# ------------------------------------------------------ the training path

def test_flash_attention_on_the_card(cuda):
    """SDPA on the card against the plain oracle: f32 within 2e-5; bf16
    within 2^-6 (the oracle rounds the probabilities to bf16 before PV, as
    the reference does; the fused kernels keep them in f32)."""
    from repro_torch.models.flash import attention_reference, flash_attention
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.randn((2, 256, 8, 64), generator=g, device=cuda)
    k, v = (torch.randn((2, 256, 2, 64), generator=g, device=cuda)
            for _ in range(2))
    for kw in ({}, {"window": 32}):
        torch.testing.assert_close(flash_attention(q, k, v, **kw),
                                   attention_reference(q, k, v, **kw),
                                   atol=2e-5, rtol=2e-5)
        qb, kb, vb = (x.to(torch.bfloat16) for x in (q, k, v))
        torch.testing.assert_close(
            flash_attention(qb, kb, vb, **kw).float(),
            attention_reference(qb, kb, vb, **kw).float(),
            atol=2.0 ** -6, rtol=2.0 ** -6)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """Two steps of the reduced glm4-9b in f32 (dcq_mad, eps 1, machine 0
    signflipped, remat) from the same weights, tokens and noise on both
    sides: per-machine gradients before each step within 1e-4 of each
    leaf's largest magnitude (the noise would hide a wrong backward pass
    in the aggregate), one B1 launch per leaf and step, aggregated
    gradients within 1e-4, losses within rtol 1e-4, parameters within
    1e-5 on 99.99% of coordinates and within 2 * lr * steps on all."""
    from chip_smoke import grads_card_vs_cpu
    from repro_torch.core.transport import tree_leaves, tree_map
    from repro_torch.data.lm import make_batch
    from repro_torch.dist.grad_agg import GradAggConfig
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.trainer import TrainConfig, make_train_step
    cfg = get_config("glm4-9b", reduced=True)
    gen = torch.Generator().manual_seed(4)
    cpu = Model(cfg, device="cpu", generator=gen, remat=True)
    card = Model(cfg, device=cuda, generator=torch.Generator(cuda),
                 remat=True)
    card.load_state_dict(cpu.state_dict())
    tcfg = TrainConfig(n_machines=4, agg=GradAggConfig(
        method="dcq_mad", attack="signflip", dp_eps=1.0, dp_n=2,
        use_pallas=True))
    opt = AdamW(lr=3e-4)
    sides = {}
    for dev, mod in ((cuda, card), ("cpu", cpu)):
        sides[str(dev)] = [make_train_step(mod, opt, tcfg), mod.params(),
                           opt.init(mod.params()),
                           torch.arange(4, device=dev) < 1, dev]
    for _ in range(2):
        batch = make_batch(gen, cfg, 8, 64)
        noise = tree_map(lambda p: torch.randn((4,) + tuple(p.shape),
                                               generator=gen),
                         sides["cpu"][1])
        err, _ = grads_card_vs_cpu((card, cpu), (sides["cuda"][1],
                                                 sides["cpu"][1]), batch,
                                   tcfg)
        assert err <= 1e-4
        out = {}
        for name, (step, params, state, mask, dev) in sides.items():
            before = kernel.launches
            params, state, m = step(
                params, state, {k: v.to(dev) for k, v in batch.items()},
                None, mask, with_agg=True,
                noise=tree_map(lambda z: z.to(dev), noise))
            if name != "cpu":
                assert kernel.launches == before + 12
            sides[name][1:3] = [params, state]
            out[name] = m
        for a, b in zip(tree_leaves(out["cuda"]["agg"]),
                        tree_leaves(out["cpu"]["agg"])):
            torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
        assert abs(out["cuda"]["loss"].item() / out["cpu"]["loss"].item()
                   - 1) < 1e-4
    d = torch.cat([(a.detach().cpu() - b.detach()).abs().flatten()
                   for a, b in zip(tree_leaves(sides["cuda"][1]),
                                   tree_leaves(sides["cpu"][1]))])
    assert (d <= 1e-5).float().mean().item() >= 0.9999
    assert d.max().item() <= 2 * 3e-4 * 2


def test_train_launcher_on_the_card(cuda, capsys):
    """``python -m repro_torch.launch.train`` on the card: 12 dispatch
    decisions per step, each one B1 launch, finite losses, the last below
    the first."""
    from repro_torch.launch import train as launcher
    mark = launch_mark()
    losses = launcher.main(["--config", "glm4-9b", "--steps", "12",
                            "--machines", "4", "--agg", "dcq",
                            "--byzantine", "0.25", "--attack", "scale"])
    launches, kern, decided = _since(mark)
    assert launches == kern == decided == 12 * 12
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert "12 leaves x 12 steps" in capsys.readouterr().out


@pytest.mark.parametrize("agg", ["dcq_mad", "median"])
def test_qn_step_on_the_card_matches_the_cpu(cuda, agg):
    """One quasi-Newton step of the reduced glm4-9b in f32 (hist 5, machine
    0 signflipped, every sigma 1e-3 on CPU-drawn normals) from the same
    weights and tokens on both sides, at chip_smoke phase 20's tolerances:
    60 B1 launches, R2's per-machine gradients at the CPU's theta_cq within
    1e-4 of each leaf's largest magnitude, counts equal, losses and grad
    norm within rtol 1e-4. The median: theta_cq, theta_os, theta_qn and the
    memory within 1e-4 on every coordinate; dcq_mad: theta_cq and theta_os
    on 99.99% of the coordinates, theta_qn and the memory on 99.9%."""
    from chip_smoke import _share_close, grads_card_vs_cpu
    from repro_torch.configs.base import TreeProtocolConfig
    from repro_torch.core import dp
    from repro_torch.core.protocol import protocol_tree_rounds
    from repro_torch.core.transport import tree_map
    from repro_torch.data.lm import make_batch
    from repro_torch.train.trainer import (TrainConfig, make_grad_fn,
                                           split_machines)
    cfg = get_config("glm4-9b", reduced=True)
    gen = torch.Generator().manual_seed(9)
    cpu = Model(cfg, device="cpu", generator=gen, remat=True)
    card = Model(cfg, device=cuda, generator=torch.Generator(cuda),
                 remat=True)
    card.load_state_dict(cpu.state_dict())
    batch = make_batch(gen, cfg, 8, 128)
    noise = {name: tree_map(lambda p: torch.randn((4,) + tuple(p.shape),
                                                  generator=gen),
                            cpu.params()) for name in dp.TREE_TRANSMISSIONS}
    proto = TreeProtocolConfig(eps=1.0, aggregator=agg)
    sigmas = {name: 1e-3 for name in dp.TREE_TRANSMISSIONS}
    out = {}
    for dev, mod in ((cuda, card), (torch.device("cpu"), cpu)):
        before = kernel.launches
        with platform_rule():
            out[dev.type] = protocol_tree_rounds(
                None, mod.params(),
                split_machines({k: v.to(dev) for k, v in batch.items()}, 4),
                make_grad_fn(mod), proto,
                byz_mask=torch.arange(4, device=dev) < 1, attack="signflip",
                sigmas=sigmas, noise={k: tree_map(lambda z: z.to(dev), v)
                                      for k, v in noise.items()})
        assert kernel.launches == before + (60 if dev.type == "cuda" else 0)
    oc, op = out["cuda"], out["cpu"]
    err, _ = grads_card_vs_cpu((card, cpu), (
        tree_map(lambda t: t.to(cuda), op.theta_cq), op.theta_cq), batch,
        TrainConfig(n_machines=4))
    assert err <= 1e-4
    for f, share in (("theta_cq", 0.9999), ("theta_os", 0.9999),
                     ("theta_qn", 0.999), ("s_hist", 0.999),
                     ("y_hist", 0.999)):
        a, b = ((getattr(oc.mem, f), getattr(op.mem, f)) if "hist" in f
                else (getattr(oc, f), getattr(op, f)))
        apart, total, _ = _share_close(a, b)
        assert apart == 0 if agg == "median" else \
            apart <= (1 - share) * total, (f, apart)
    assert torch.equal(oc.mem.count.cpu(), op.mem.count)
    torch.testing.assert_close(oc.losses.cpu(), op.losses, rtol=1e-4, atol=0)
    torch.testing.assert_close(oc.grad_norm.cpu(), op.grad_norm, rtol=1e-4,
                               atol=0)


# ------------------------------------------------ the model zoo's families

@pytest.mark.parametrize("arch", ["xlstm-125m", "qwen3-moe-30b-a3b",
                                  "zamba2-7b", "llava-next-mistral-7b",
                                  "musicgen-medium", "zamba2-7b@dh112"])
def test_zoo_family_on_the_card_matches_the_cpu(cuda, arch):
    """chip_smoke phase 26 for one reduced family in f32 at seed 2600: the
    loss and its gradients, two median QN steps from the CPU's state
    (every coordinate of the parameters, s and y within 1e-4, y's atol
    scaled by its largest magnitude; the CPU's y at the card's theta_os and
    theta_cq equal to the card's on every coordinate) and 8 greedy decode
    steps with every B2 launch held against the plain version; the vlm
    and audio families and the hybrid at head dim 112 (``zamba2-7b@dh112``)
    too. zamba2-7b
    at this seed has 50 coordinates of y (of ~35 M) apart by up to
    1.39e-4: its y is held at 1e-4 on 99.99% and at 1e-3 on all, beside
    the same-points witness, which holds every coordinate (PERF.md, open
    questions)."""
    from chip_smoke import _zoo_vs_cpu
    y_share = 0.9999 if arch.startswith("zamba2-7b") else 1.0
    row = _zoo_vs_cpu(arch, 2600, y_share)
    print(f"\n{arch} at seed 2600: QN median steps {row['qn_steps']}")
    assert row["max_rel_grad_diff"] <= 1e-4
    for g in row["qn_steps"]:
        for f, gap in g.items():
            assert gap["apart"] <= ((1 - y_share) * gap["of"]
                                    if f == "y_hist" else 0), (f, gap)


def test_zoo_train_launcher_on_the_card(cuda, capsys):
    """``python -m repro_torch.launch.train --optimizer qn`` at its default
    arch (xlstm-125m, 17 leaves) on the card: 85 dispatch decisions a
    step, each one B1 launch, finite losses."""
    from repro_torch.launch import train as launcher
    mark = launch_mark()
    losses = launcher.main(["--steps", "2", "--seq", "32", "--optimizer",
                            "qn"])
    launches, kern, decided = _since(mark)
    assert launches == kern == decided == 2 * 85
    assert all(np.isfinite(losses))
    assert "5 transmissions x 17 leaves x 2 steps" in capsys.readouterr().out


def test_zoo_decode_at_head_dim_112_on_the_card(cuda):
    """zamba2-7b's full-width head dim, 112, on the card: a hybrid of
    d_model 224 and 2 heads (head dim 112) decodes 8 greedy steps through
    B2 (one launch per shared-attention insertion and step, each held
    against the plain version), its logits within atol = rtol = 1e-4 of
    the same model on the CPU, in f32; a head dim the kernel does not take
    (96) still raises with no fallback and no launch."""
    import dataclasses
    base = get_config("zamba2-7b", reduced=True)
    cfg = dataclasses.replace(base, d_model=224, n_heads=2, n_kv_heads=2,
                              dtype="float32")
    assert cfg.head_dim == 112
    cpu = Model(cfg, device="cpu",
                generator=torch.Generator().manual_seed(5))
    card = Model(cfg, device="meta")
    card.load_state_dict({k: v.to(cuda) for k, v in cpu.state_dict().items()},
                         assign=True)
    cc, gc = cpu.init_cache(2, 8), card.init_cache(2, 8)
    tok = torch.tensor([[3], [11]])
    real, held = gqa.gqa_decode, []

    def gqa_held(q, k, v, cache_len):
        got = real(q, k, v, cache_len)
        if q.is_cuda:                  # the CPU model's calls are plain
            torch.testing.assert_close(
                got, gqa.gqa_decode_plain(q, k, v, cache_len), atol=2e-5,
                rtol=1e-4)
            held.append(tuple(q.shape))
        return got

    before = gqa.launches
    gqa.gqa_decode = gqa_held
    try:
        for _ in range(8):
            lc, cc = cpu.decode_step(cc, {"tokens": tok})
            lg, gc = card.decode_step(gc, {"tokens": tok.to(cuda)})
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
            tok = lc.argmax(-1)
    finally:
        gqa.gqa_decode = real
    assert gqa.launches == before + 8 * card.n_shared == before + len(held)
    assert {s[-1] for s in held} == {112}
    odd = Model(dataclasses.replace(base, d_model=192, n_heads=2,
                                    n_kv_heads=2), device=cuda)
    assert odd.cfg.head_dim == 96
    with pytest.raises(ValueError, match="Dh in"):
        odd.decode_step(odd.init_cache(1, 4),
                        {"tokens": torch.zeros((1, 1), dtype=torch.long,
                                               device=cuda)})
    assert gqa.launches == before + len(held)
