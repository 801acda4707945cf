"""repro_torch.agg against repro.agg: every aggregation rule of the port's
reference against the JAX reference, the order-statistics kernel's plain
version against the interpreted Pallas kernel, and the wrapper's dispatch
(plain version on CPU tensors, the CUDA kernel or an error otherwise).
Inputs are numpy arrays from a seed, handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import agg as jagg
from repro.agg import reference as jref
from repro.agg.kernel import ostat_pallas
from repro_torch import agg as tagg
from repro_torch.agg import kernel as tkernel
from repro_torch.agg import reference as tref

RULES = ("mean", "median", "trimmed", "geomedian", "dcq", "dcq_mad")
#: tolerance of tests/test_agg.py for float32 rules that sum
ATOL, RTOL = 5e-5, 1e-4


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    values = rng.standard_normal(shape).astype(np.float32)
    scale = (np.abs(rng.standard_normal(shape[:-2] + shape[-1:]))
             + 0.1).astype(np.float32)
    return values, scale


def _p999_rel(got, ref):
    """99.9th percentile of |err| / max(1, |ref|): CQ knot ties flip
    single indicators, so the sum-based ops are gated on this and not on
    the max (the gate of repro.agg.autotune)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    rel = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    return float(np.quantile(rel, 0.999))


# -------------------------------------------------------------- references

@pytest.mark.parametrize("p", [1, 5, 300])
@pytest.mark.parametrize("m", [7, 8, 51])
@pytest.mark.parametrize("method", RULES)
def test_reference_rules_match_jax(method, m, p):
    values, scale = _inputs((3, m, p), seed=m * 1000 + p)
    needs = jagg.get_aggregator(method).needs_scale
    got = tagg.aggregate_batched(torch.from_numpy(values), method,
                                 scale=torch.from_numpy(scale) if needs
                                 else None, backend="reference")
    ref = jagg.aggregate_batched(jnp.asarray(values), method,
                                 scale=jnp.asarray(scale) if needs else None,
                                 backend="reference")
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape == (3, p)
    if method == "median":
        # both sort; an even count averages the middle pair (1 ulp)
        np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    else:
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("m", [7, 8])
def test_reference_helpers_match_jax(m):
    values, _ = _inputs((m, 6), seed=m)
    tv, jv = torch.from_numpy(values), jnp.asarray(values)
    for t_out, j_out in zip(tref.median_mad_dcq_reference(tv),
                            jref.median_mad_dcq_reference(jv)):
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        tref.median_deviation_variance(tv, 200).numpy(),
        np.asarray(jref.median_deviation_variance(jv, 200)),
        atol=ATOL, rtol=RTOL)
    np.testing.assert_array_max_ulp(tref.median_agg(tv).numpy(),
                                    np.asarray(jref.median_agg(jv)),
                                    maxulp=1)


@pytest.mark.parametrize("K", [1, 5, 10, 20])
def test_quantile_levels_and_knots(K):
    np.testing.assert_array_equal(tref.quantile_levels(K).numpy(),
                                  np.asarray(jref.quantile_levels(K)))
    # two float32 ndtri implementations differ by a few ulp (at most
    # 3.6e-7 for K <= 20 on knots of magnitude <= 2)
    np.testing.assert_allclose(tref.quantile_knots(K).numpy(),
                               np.asarray(jref.quantile_knots(K)),
                               atol=5e-7, rtol=0)


def test_registry_contents():
    assert tagg.registered() == jagg.registered()
    for name in RULES:
        t, j = tagg.get_aggregator(name), jagg.get_aggregator(name)
        assert t.needs_scale == j.needs_scale
        assert t.batching == j.batching
        assert (t.kernel is None) == (j.pallas is None)
    with pytest.raises(KeyError, match="unknown aggregator"):
        tagg.get_aggregator("nope")


# ------------------------------------------------------ the kernel's twin

@pytest.mark.parametrize("n_bisect", [32, 60])
@pytest.mark.parametrize("op", tkernel.OPS)
def test_ostat_plain_matches_interpreted_pallas(op, n_bisect):
    """Both shapes in one case: m = 8 (two searches for the median) with a
    ragged p, and m = 7 (one search)."""
    for shape in ((2, 8, 40), (3, 7, 5)):
        values, scale = _inputs(shape, seed=shape[1])
        sc = scale if op == "dcq" else None
        kw = dict(kth=3, n_bisect=n_bisect)
        got = tkernel.ostat_plain(
            torch.from_numpy(values), op,
            None if sc is None else torch.from_numpy(sc), **kw)
        ref = ostat_pallas(jnp.asarray(values), op,
                           None if sc is None else jnp.asarray(sc),
                           interpret=True, **kw)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            g, r = g.numpy(), np.asarray(r)
            assert g.shape == r.shape == shape[:1] + shape[2:]
            if op in ("kth", "median"):
                # exact compares and fp32 halvings only: bit-equal
                np.testing.assert_array_equal(g, r)
            else:
                assert _p999_rel(g, r) <= 1e-5


def test_ostat_plain_bisection_is_the_order_statistic():
    """For k >= 1 the converged upper bracket is the k-th order statistic
    itself. For k = 0 the search starts at lo = min, whose rank is already
    1, so it ends within one ulp above the minimum (as the reference's
    Pallas kernel does)."""
    values, _ = _inputs((4, 9, 33), seed=3)
    v = torch.from_numpy(values)
    srt = v.sort(dim=-2).values
    for k in range(1, 9):
        got = tkernel.ostat_plain(v, "kth", kth=k)
        torch.testing.assert_close(got, srt[:, k], atol=0, rtol=0)
    low = tkernel.ostat_plain(v, "kth", kth=0).numpy()
    assert (low >= srt[:, 0].numpy()).all()
    np.testing.assert_array_max_ulp(low, srt[:, 0].numpy(), maxulp=1)


# ------------------------------------------------ the kernel's lane groups

PLAN_MS = (1, 2, 7, 8, 31, 32, 33, 51, 64, 65, 81, 1000, 2000)


@pytest.mark.parametrize("m", PLAN_MS)
def test_ostat_plan_lays_out_every_row(m):
    """At the main path's batch shapes and the gradient shape: lanes a
    power of two <= 32; lane s holds rows s, s + lanes, ..., all m rows
    once; in registers where ceil(m / lanes) fits the kernel's register
    rows, else in the slab where the block's columns fit 227 KB, else
    device memory."""
    for nb, p in ((20, 10), (1, 1), (8, 4096), (1, 262144)):
        plan = tkernel.ostat_plan(nb, m, p)
        G = plan.lanes
        assert 1 <= G <= 32 and G & (G - 1) == 0
        rows = sorted(i for s in range(G) for i in range(s, m, G))
        assert rows == list(range(m))
        need = -(-m // G)
        if plan.reg_rows:
            assert plan.reg_rows in tkernel.REG_ROWS
            assert need <= plan.reg_rows and not plan.slab
        else:
            assert need > tkernel.REG_ROWS[-1] and G == 32
            assert plan.slab == ((tkernel.BLOCK // G) * m * 4
                                 <= tkernel.MAX_SMEM)
    # the paper's shapes: a full warp on each of the 200 coordinates; the
    # gradient shape: one lane with its 8 rows in registers
    if m in (51, 81):
        assert tkernel.ostat_plan(20, m, 10) == tkernel.OstatPlan(
            32, {51: 2, 81: 4}[m], False)
    if m == 8:
        assert tkernel.ostat_plan(1, 8, 262144) == tkernel.OstatPlan(
            1, 8, False)
    # between one lane and a warp where the card lacks the threads for a
    # warp per coordinate: the fewest lanes that hold the rows
    if m in (31, 32, 33, 51, 64, 65):
        lanes = tkernel.ostat_plan(1, m, 262144).lanes
        assert -(-m // lanes) <= 8 < -(-m // (lanes // 2))
    if m >= 1000:
        assert tkernel.ostat_plan(20, m, 10).slab
    # a column past the slab is read from device memory
    assert not tkernel.ostat_plan(1, 20000, 3).slab


def _same_bits(a, b):
    return a.view(torch.int32) == b.view(torch.int32)


def _group_search(vals, ks, n_bisect, lanes, warp):
    """The kernel's search (csrc/ostat.cu kth) in eager PyTorch: the
    ks-th smallest of every column of vals (N, m, P) by the same f32
    halvings, the count at each threshold summed over `lanes` lanes that
    hold rows s, s + lanes, ...; columns stop in groups of `warp` (the
    kernel's vote) once a step leaves every bracket of the group
    bit-identical. Returns the upper brackets and the number of steps
    taken."""
    lo0, hi0 = vals.amin(dim=-2), vals.amax(dim=-2)
    lo, hi = [lo0.clone() for _ in ks], [hi0.clone() for _ in ks]
    active = torch.ones_like(lo0, dtype=torch.bool)

    def count(t):
        le = vals <= t.unsqueeze(-2)
        return sum(le[:, s::lanes].sum(dim=-2) for s in range(lanes))

    def vote(fixed):
        flat = fixed.reshape(-1)
        n = flat.numel()
        pad = torch.ones(-(-n // warp) * warp, dtype=torch.bool)
        pad[:n] = flat
        return pad.reshape(-1, warp).all(dim=1).repeat_interleave(warp)[:n] \
            .reshape(fixed.shape)

    it = 0
    while it < n_bisect and bool(active.any()):
        fixed = torch.ones_like(active)
        for j, k in enumerate(ks):
            a, b = lo[j], hi[j]
            mid = 0.5 * (a + b)
            right = count(mid) <= k
            na, nb = torch.where(right, mid, a), torch.where(right, b, mid)
            fixed &= _same_bits(na, a) & _same_bits(nb, b)
            lo[j] = torch.where(active, na, a)
            hi[j] = torch.where(active, nb, b)
        active &= ~vote(fixed)
        it += 1
    return hi, it


def _hard_columns(m, seed):
    """(3, m, 40) f32: ties (small integers), constant columns, mixed
    +-0.0, and magnitudes from 1e-30 to 1e30 of both signs."""
    rng = np.random.default_rng(seed)
    ties = rng.integers(-2, 3, size=(m, 40)).astype(np.float32)
    ties[:, :4] = 1.5                                   # constant columns
    ties[:, 4:8] = 0.0
    zeros = np.where(rng.random((m, 40)) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[:, ::3] = rng.standard_normal((m, 14)).astype(np.float32) * 1e-30
    wide = (10.0 ** rng.uniform(-30, 30, size=(m, 40))
            * rng.choice([-1.0, 1.0], size=(m, 40))).astype(np.float32)
    return torch.from_numpy(np.stack([ties, zeros, wide]))


@pytest.mark.parametrize("m", [1, 2, 7, 8, 51])
def test_fixed_point_exit_is_bit_equal(m):
    """The kernel's exit rule returns the bits of all n_bisect halvings:
    the lane-group search with the fixed-point exit (per column, and voted
    over a whole warp of columns) equals ostat_plain's kth and median bit
    for bit, on ties, constant columns, +-0.0, m = 1 and magnitudes from
    1e-30 to 1e30, at an even and an odd trip count."""
    v = _hard_columns(m, seed=m)
    for n_bisect in (60, 33):
        for lanes in (1, 8, 32):
            for warp in (1, 32 // lanes, 120):
                ks = [(m - 1) // 2] if m % 2 else [m // 2 - 1, m // 2]
                (*his,), steps = _group_search(v, ks, n_bisect, lanes, warp)
                med = his[0] if m % 2 else 0.5 * (his[0] + his[1])
                plain = tkernel.ostat_plain(v, "median", n_bisect=n_bisect)
                assert bool(_same_bits(med, plain).all())
                for k in {0, m // 3, m - 1}:
                    (hi,), _ = _group_search(v, [k], n_bisect, lanes, warp)
                    plain = tkernel.ostat_plain(v, "kth", kth=k,
                                                n_bisect=n_bisect)
                    assert bool(_same_bits(hi, plain).all())
                assert steps <= n_bisect


def test_fixed_point_exit_ends_early_on_random_data():
    """On normal draws at the paper's m the search pins every column of a
    warp long before 60 halvings (the kernel's saving)."""
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (20, 51, 10)).astype(np.float32))
    (hi,), steps = _group_search(v, [25], 60, 32, 1)
    assert steps < 45
    assert bool(_same_bits(hi, tkernel.ostat_plain(v, "median")).all())


# -------------------------------------------------- the small-m path's twin

def _expo(x):
    return (x.view(torch.int32) >> 23) & 0xFF


def _small_search(x, lo0, hi0, n_bisect):
    """The small-m path's search (csrc/ostat.cu search) in eager PyTorch:
    the upper bracket of n_bisect halvings from (lo0, hi0) toward x, the
    selected k-th value, in closed form where the source's note proves its
    bits, else replayed with one compare a step. Returns the brackets and
    the mask of replayed columns."""
    w = hi0 - lo0
    ex = _expo(x)
    fast = ((torch.maximum(lo0.abs(), hi0.abs()) <= 2.0 ** 126)
            & (ex >= 27) & (ex <= 254) & (_expo(w) - ex + 32 <= n_bisect))
    xb = x.view(torch.int32)
    up = torch.where(x > 0, xb + 1, xb - 1).view(torch.float32)
    res = torch.where((x == lo0) & (w != 0) & ((xb & 1) == 1), up, x)
    eh = _expo(hi0)
    zero = ((x == 0) & (lo0 == 0) & (hi0 > 0) & (eh > n_bisect)
            & (eh <= 254))
    halved = (hi0.view(torch.int32) - (n_bisect << 23)).view(torch.float32)
    res = torch.where(zero, halved, res)
    replayed = ~(fast | zero)
    lo, hi = lo0.clone(), hi0.clone()
    for _ in range(n_bisect if bool(replayed.any()) else 0):
        mid = 0.5 * (lo + hi)
        right = ~(mid >= x)
        lo, hi = torch.where(right, mid, lo), torch.where(right, hi, mid)
    return torch.where(replayed, hi, res), replayed


def _small_median(vals, n_bisect):
    """The median of every column of vals (N, m, P) by the network's
    order and the search above: (median, replayed)."""
    m = vals.shape[-2]
    srt = vals.sort(dim=-2).values
    lo0, hi0 = vals.amin(dim=-2), vals.amax(dim=-2)
    if m % 2:
        return _small_search(srt[:, (m - 1) // 2], lo0, hi0, n_bisect)
    a, ra = _small_search(srt[:, m // 2 - 1], lo0, hi0, n_bisect)
    b, rb = _small_search(srt[:, m // 2], lo0, hi0, n_bisect)
    return 0.5 * (a + b), ra | rb


def _small_median_mad(vals, n_bisect):
    """(median, raw MAD, replayed) as the small-m path's median_mad_dcq
    takes them."""
    med, r1 = _small_median(vals, n_bisect)
    mad, r2 = _small_median((vals - med.unsqueeze(-2)).abs(), n_bisect)
    return med, mad, r1 | r2


def _training_stacks(m, p, seed):
    """(1, m, p) bf16-rounded f32: per-coordinate gradients over six
    decades plus per-machine noise, machine 0 sign-flipped, and one column
    in eight with its rows equal in pairs (so that the middle rows of an
    even m and the MAD's smallest deviations tie)."""
    g = torch.Generator().manual_seed(seed)
    base = torch.randn(p, generator=g) \
        * 10.0 ** torch.empty(p).uniform_(-6, 0, generator=g)
    v = base + 0.5 * base.abs().mean() * torch.randn((m, p), generator=g)
    v[0] = -v[0]
    pairs = torch.rand(p, generator=g) < 0.125
    v[:, pairs] = v[torch.arange(m) // 2 * 2][:, pairs]
    return v.to(torch.bfloat16).float().unsqueeze(0)


def _binade_edges(m, seed):
    """(1, m, 4000) f32: powers of two and their neighbours, odd low
    mantissa bits, both signs, magnitudes from 2^-140 to 2^126, zeros of
    both signs and rows repeated from row 0 (the descents onto the
    minimum)."""
    g = torch.Generator().manual_seed(seed)
    shape = (m, 4000)
    e = torch.where(torch.rand(shape, generator=g) < 0.7,
                    torch.randint(-8, 8, shape, generator=g),
                    torch.randint(-140, 127, shape, generator=g)).float()
    mant = torch.where(torch.rand(shape, generator=g) < 0.3, 1.0,
                       1.0 + torch.rand(shape, generator=g))
    v = torch.where(torch.rand(shape, generator=g) < 0.5, -1.0, 1.0) \
        * mant * torch.pow(2.0, e)
    v = (v.view(torch.int32) + torch.randint(-2, 3, shape, generator=g,
                                             dtype=torch.int32)).view(
        torch.float32)
    v = torch.where(torch.isfinite(v), v, 0.0)
    cols = (torch.rand(4000, generator=g) < 0.4).nonzero().squeeze(1)
    rows = torch.randint(0, m, (cols.numel(),), generator=g)
    v[rows, cols] = v[0, cols]
    zero = torch.rand(shape, generator=g) < 0.05
    v[zero] = torch.where(torch.rand(shape, generator=g) < 0.5, -0.0,
                          0.0)[zero]
    return v.unsqueeze(0)


SMALL_FAMILIES = {
    "hard": lambda m: _hard_columns(m, seed=m),
    "hard_bf16": lambda m: _hard_columns(m, seed=m).to(torch.bfloat16)
    .float(),
    "edges": lambda m: _binade_edges(m, seed=m),
    "training": lambda m: _training_stacks(m, 4000, seed=m),
}


@pytest.mark.parametrize("family", sorted(SMALL_FAMILIES))
@pytest.mark.parametrize("n_bisect", [60, 33, 5, 0])
@pytest.mark.parametrize("m", range(1, 9))
def test_small_path_twin_is_bit_equal(m, n_bisect, family):
    """The small-m path's closed forms and replay return the bits of all
    n_bisect halvings: kth at every k, the median, and the median and
    MAD of median_mad_dcq equal ostat_plain bit for bit, on ties,
    constant columns, +-0.0, 1e-30..1e30, binade edges, odd mantissas,
    training-like bf16 stacks, and trip counts down to none."""
    v = SMALL_FAMILIES[family](m)
    srt = v.sort(dim=-2).values
    lo0, hi0 = v.amin(dim=-2), v.amax(dim=-2)
    for k in range(m):
        got, _ = _small_search(srt[:, k], lo0, hi0, n_bisect)
        ref = tkernel.ostat_plain(v, "kth", kth=k, n_bisect=n_bisect)
        assert bool(_same_bits(got, ref).all()), k
    med, _ = _small_median(v, n_bisect)
    assert bool(_same_bits(
        med, tkernel.ostat_plain(v, "median", n_bisect=n_bisect)).all())
    med, mad, _ = _small_median_mad(v, n_bisect)
    rmed, rmad, _ = tkernel.ostat_plain(v, "median_mad_dcq",
                                        n_bisect=n_bisect)
    assert bool(_same_bits(med, rmed).all())
    assert bool(_same_bits(mad, rmad).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_path_twin_engages_on_training_stacks(seed):
    """On bf16 training stacks at m = 4, the closed forms take nearly
    every coordinate of dcq_mad's four searches, the MAD's descents onto
    a tied minimum (zero where the middle rows are equal) included: the
    replayed share stays under 1%."""
    v = _training_stacks(4, 50_000, seed=100 + seed)
    med, mad, replayed = _small_median_mad(v, 60)
    rmed, rmad, _ = tkernel.ostat_plain(v, "median_mad_dcq")
    assert bool(_same_bits(med, rmed).all() & _same_bits(mad, rmad).all())
    assert float(replayed.float().mean()) < 0.01


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    values, scale = _inputs((2, 8, 12), seed=5)
    v, sc = torch.from_numpy(values), torch.from_numpy(scale)
    before = tkernel.launches
    for op in tkernel.OPS:
        s = sc if op == "dcq" else None
        got = tkernel.ostat(v, op, s, kth=2)
        ref = tkernel.ostat_plain(v, op, s, kth=2)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, atol=0, rtol=0)
    # backend="kernel" on a CPU tensor reaches the same plain version
    torch.testing.assert_close(
        tagg.aggregate(v[0], "dcq", scale=sc[0], backend="kernel"),
        tkernel.ostat_plain(v[0], "dcq", sc[0]), atol=0, rtol=0)
    assert tkernel.launches == before


def test_wrapper_keeps_dtype_and_batch_layout():
    values, _ = _inputs((2, 3, 7, 5), seed=6)
    v = torch.from_numpy(values).to(torch.float64)
    out = tkernel.ostat(v, "median")
    assert out.dtype == torch.float64 and out.shape == (2, 3, 5)
    torch.testing.assert_close(
        out, tref.median_agg(v.float(), axis=-2).double(), atol=0, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    v = torch.zeros((2, 5, 3))
    with pytest.raises(ValueError, match="unknown order-statistics op"):
        tkernel.ostat(v, "mode")
    with pytest.raises(ValueError, match="needs a per-coordinate scale"):
        tkernel.ostat(v, "dcq")
    with pytest.raises(ValueError, match="kth=5"):
        tkernel.ostat(v, "kth", kth=5)
    with pytest.raises(ValueError, match="too large"):
        tkernel.ostat(v, "trimmed", trim_beta=0.6)
    with pytest.raises(ValueError, match="need a"):
        tkernel.ostat(torch.zeros(5), "median")
    with pytest.raises(TypeError, match="floating-point"):
        tkernel.ostat(torch.zeros((5, 3), dtype=torch.int32), "median")
    # a meta tensor is a dry-run trace: B1's shape rule, nothing computed,
    # no launch counted (before the machine model it was refused here)
    before = tkernel.launches
    out = tkernel.ostat(torch.zeros((5, 3), device="meta"), "median")
    assert out.device.type == "meta" and out.shape == (3,)
    assert tkernel.launches == before


def test_dispatch_on_cpu_runs_the_reference():
    values, scale = _inputs((3, 8, 6), seed=7)
    v, sc = torch.from_numpy(values), torch.from_numpy(scale)
    for method in RULES:
        s = sc if tagg.get_aggregator(method).needs_scale else None
        got = tagg.aggregate_batched(v, method, scale=s)
        ref = tagg.aggregate_batched(v, method, scale=s,
                                     backend="reference")
        torch.testing.assert_close(got, ref, atol=0, rtol=0)
    med, mad, dcq = tagg.median_mad_dcq(v)
    for g, r in zip((med, mad, dcq), tref.median_mad_dcq_reference(v,
                                                                   axis=-2)):
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    with pytest.raises(ValueError, match="unknown backend"):
        tagg.aggregate(v[0], "median", backend="pallas")
