"""repro_torch.kernels.gqa_decode against repro.kernels: the plain version
of the GQA flash-decode kernel against the interpreted Pallas kernel and
its jnp oracle (the shape sweep, dtypes, model path and length invariance
of tests/test_kernels.py), the known bf16 difference from the model's jnp
path, and the wrapper's dispatch (plain version on CPU tensors, errors on
what the kernel does not take). Inputs are numpy arrays from a seed,
handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gqa_decode import gqa_decode_pallas
from repro.kernels.gqa_decode_ref import gqa_decode_reference
from repro.models import flash as jflash
from repro_torch.kernels import gqa_decode as tk
from repro_torch.models import flash as tflash

#: tests/test_kernels.py's tolerances: f32 kernel against oracle, and a
#: bf16 kernel against the f32 oracle of the same (bf16-rounded) inputs
ATOL, RTOL = 2e-5, 1e-4
ATOL_BF16, RTOL_BF16 = 0.05, 0.05


def _inputs(B, S, Hq, Hkv, Dh, seed, lens=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    clen = (rng.integers(1, S + 1, size=B) if lens is None
            else np.asarray(lens)).astype(np.int32)
    return q, k, v, clen


def _torch(arrays, dtype):
    q, k, v, clen = arrays
    return (*(torch.from_numpy(a).to(dtype) for a in (q, k, v)),
            torch.from_numpy(clen))


def _jax(arrays, dtype):
    q, k, v, clen = arrays
    return (*(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
            jnp.asarray(clen))


SWEEP = [(2, 128, 8, 2, 64, 32),
         (3, 96, 4, 4, 128, 64),
         (1, 1024, 16, 2, 128, 256),
         (4, 33, 8, 1, 64, 16),      # ragged S vs tile
         # zamba2-7b's head dim (3584 / 32), g = 4 and g = 1, ragged S
         (2, 160, 8, 2, 112, 64),
         (3, 40, 4, 4, 112, 16)]


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,ts", SWEEP)
def test_plain_matches_pallas_and_oracle_f32(B, S, Hq, Hkv, Dh, ts):
    arrays = _inputs(B, S, Hq, Hkv, Dh, seed=B * S)
    got = tk.gqa_decode_plain(*_torch(arrays, torch.float32))
    assert got.dtype == torch.float32 and got.shape == (B, Hq, Dh)
    jin = _jax(arrays, jnp.float32)
    pallas = gqa_decode_pallas(*jin, ts=ts)
    ref = gqa_decode_reference(*jin)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("B,S,Hq,Hkv,Dh,ts",
                         SWEEP + [(2, 64, 8, 2, 64, 32)])
def test_plain_matches_pallas_bf16(B, S, Hq, Hkv, Dh, ts):
    """bf16 in, bf16 out; against the f32 oracle of the bf16-rounded
    inputs at the JAX dtype test's tolerance, and against the interpreted
    Pallas kernel in bf16 to one bf16 rounding of the output."""
    arrays = _inputs(B, S, Hq, Hkv, Dh, seed=B * S + 1)
    got = tk.gqa_decode_plain(*_torch(arrays, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.to(torch.float32).numpy()
    jin = _jax(arrays, jnp.bfloat16)
    ref = gqa_decode_reference(*(a.astype(jnp.float32) for a in jin[:3]),
                               jin[3])
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_BF16,
                               rtol=RTOL_BF16)
    pallas = np.asarray(gqa_decode_pallas(*jin, ts=ts), np.float32)
    # both round an f32 result to bf16 once: at most 1 bf16 ulp apart
    np.testing.assert_allclose(got, pallas, atol=1e-6, rtol=2.0 ** -7)


def test_plain_matches_the_model_path():
    """As test_gqa_decode_matches_model_path: the kernel's function agrees
    with the reference model's flash.decode_attention in f32, through the
    port's own model entry too."""
    B, S, Hq, Hkv, Dh = 2, 256, 8, 2, 64
    arrays = _inputs(B, S, Hq, Hkv, Dh, seed=9, lens=[S, S // 2])
    q, k, v, clen = _jax(arrays, jnp.float32)
    model_out = np.asarray(jflash.decode_attention(q[:, None], k, v, clen))
    tq, tk_, tv, tl = _torch(arrays, torch.float32)
    got = tk.gqa_decode_plain(tq, tk_, tv, tl)
    np.testing.assert_allclose(got.numpy(), model_out[:, 0], atol=ATOL,
                               rtol=RTOL)
    entry = tflash.decode_attention(tq[:, None], tk_, tv, tl)
    assert entry.shape == (B, 1, Hq, Dh)
    np.testing.assert_allclose(entry.numpy(), model_out, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("S,clen", [(8, 1), (8, 8), (33, 17), (64, 1),
                                    (96, 95), (128, 40), (200, 200),
                                    (200, 3)])
def test_length_invariance(S, clen):
    """Entries past cache_len never affect the output, not even garbage
    of 100x the scale (tests/test_kernels.py:120, as parametrised
    cases); the same holds for the interpreted Pallas kernel, which the
    plain version matches."""
    rng = np.random.default_rng(S * 31 + clen)
    q = rng.standard_normal((1, 4, 64)).astype(np.float32)
    k = rng.standard_normal((1, S, 2, 64)).astype(np.float32)
    v = rng.standard_normal((1, S, 2, 64)).astype(np.float32)
    garbage = (100.0 * rng.standard_normal((1, S, 2, 64))).astype(np.float32)
    k2, v2 = k.copy(), v.copy()
    k2[:, clen:], v2[:, clen:] = garbage[:, clen:], garbage[:, clen:]
    cl = np.array([clen], np.int32)
    a = tk.gqa_decode_plain(*_torch((q, k, v, cl), torch.float32))
    b = tk.gqa_decode_plain(*_torch((q, k2, v2, cl), torch.float32))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)
    pallas = gqa_decode_pallas(*_jax((q, k2, v2, cl), jnp.float32), ts=32)
    np.testing.assert_allclose(b.numpy(), np.asarray(pallas), atol=ATOL,
                               rtol=RTOL)


def test_bf16_probability_rounding_difference():
    """The known bf16 difference, measured at the reduced glm4-9b's
    attention shape (Hq = 4, Hkv = 2, Dh = 64). The model's jnp path
    rounds the probabilities p to bf16 before the PV product; the kernel
    keeps them in f32. Each rounded p_t is off by at most 2^-9 p_t, so the
    f32 outputs differ by at most 2^-9 * max|v| (the p_t sum to one);
    rounding both to bf16 adds at most one bf16 ulp, 2^-8 |out|. The
    difference is there (not a bit-equal pair) and within that bound."""
    B, S, Hq, Hkv, Dh = 2, 32, 4, 2, 64
    arrays = _inputs(B, S, Hq, Hkv, Dh, seed=12, lens=[S, 9])
    q, k, v, clen = _jax(arrays, jnp.bfloat16)
    model = np.asarray(jflash.decode_attention(q[:, None], k, v, clen),
                       np.float32)[:, 0]
    got = tk.gqa_decode_plain(*_torch(arrays, torch.bfloat16)) \
        .to(torch.float32).numpy()
    vmax = float(np.abs(np.asarray(v, np.float32)).max())
    diff = np.abs(got - model)
    bound = 2.0 ** -9 * vmax + 2.0 ** -8 * np.abs(model)
    assert diff.max() > 0
    assert (diff <= bound).all(), float((diff - bound).max())


# ------------------------------------------------------------------ wrapper

def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    arrays = _inputs(2, 40, 8, 2, 64, seed=3)
    before = tk.launches
    t = _torch(arrays, torch.float32)
    torch.testing.assert_close(tk.gqa_decode(*t), tk.gqa_decode_plain(*t),
                               atol=0, rtol=0)
    tb = _torch(arrays, torch.bfloat16)
    assert tk.gqa_decode(*tb).dtype == torch.bfloat16
    assert tk.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v, cl = _torch(_inputs(2, 40, 8, 2, 64, seed=4), torch.float32)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        tk.gqa_decode(q.half(), k.half(), v.half(), cl)
    with pytest.raises(TypeError, match="float32 or all bfloat16"):
        tk.gqa_decode(q, k.to(torch.bfloat16), v, cl)
    with pytest.raises(ValueError, match="int32"):
        tk.gqa_decode(q, k, v, cl.long())
    with pytest.raises(ValueError, match="int32"):
        tk.gqa_decode(q, k, v, cl[:1])
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tk.gqa_decode(q[:, :7], k, v, cl)
    with pytest.raises(ValueError, match="does not match"):
        tk.gqa_decode(q[:1], k, v, cl[:1])
    with pytest.raises(ValueError, match="need q"):
        tk.gqa_decode(q, k, v[:, :3], cl)
    with pytest.raises(ValueError, match="Dh in"):
        tk.gqa_decode(q[..., :32].contiguous(), k[..., :32].contiguous(),
                      v[..., :32].contiguous(), cl)
    q96, k96 = torch.zeros((2, 8, 96)), torch.zeros((2, 40, 2, 96))
    with pytest.raises(ValueError, match="Dh in"):
        tk.gqa_decode(q96, k96, k96, cl)
    big_q = torch.zeros((2, 34, 64))
    one_kv = torch.zeros((2, 40, 1, 64))
    with pytest.raises(ValueError, match="Hq / Hkv"):
        tk.gqa_decode(big_q, one_kv, one_kv, cl)
    with pytest.raises(ValueError, match="contiguous"):
        tk.gqa_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                      cl)
    with pytest.raises(ValueError, match="several devices"):
        tk.gqa_decode(q, k, v, cl.to("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tk.gqa_decode(q.to("meta"), k.to("meta"), v.to("meta"),
                      cl.to("meta"))


@pytest.mark.parametrize("B,S,Hkv,sms,resident,chunk,n_chunks", [
    (8, 32768, 2, 132, 1, 4096, 8),    # the main path: 128 of 132 slots
    (8, 32768, 2, 132, 2, 2048, 16),
    (8, 32768, 2, 132, 3, 1408, 24),
    (1, 1024, 2, 132, 2, 64, 16),
    (4, 33, 1, 132, 2, 64, 1),
    (128, 32768, 2, 132, 2, 32768, 1)])
def test_split_covers_the_cache(B, S, Hkv, sms, resident, chunk, n_chunks):
    plan = tk.split_plan(B, S, Hkv, sms, resident)
    assert (plan.chunk, plan.n_chunks) == (chunk, n_chunks)
    assert chunk % 64 == 0 and (n_chunks - 1) * chunk < S <= n_chunks * chunk
    assert plan.blocks == B * Hkv * n_chunks
    assert plan.slots == sms * resident


@pytest.mark.parametrize("resident", [1, 2, 3, 4])
@pytest.mark.parametrize("B,S,Hkv", [
    (8, 32768, 2), (3, 96, 4), (2, 128, 2), (1, 1024, 2), (4, 33, 1),
    (2, 4096, 2), (256, 4096, 2), (600, 4096, 1)])
def test_split_plan_fills_whole_waves(B, S, Hkv, resident):
    """The blocks fit one wave of the card's block slots whenever the
    (sequence, kv head) pairs do, and then fill most of it at a long
    cache (the main shape); past that, one chunk per pair in the fewest
    waves. Chunks stay multiples of the 64 slots a block's warps walk,
    cover S, and are the smallest that do."""
    sms = 132
    plan = tk.split_plan(B, S, Hkv, sms, resident)
    slots, pairs = sms * resident, B * Hkv
    assert plan.chunk % tk.MIN_CHUNK == 0
    assert (plan.n_chunks - 1) * plan.chunk < S <= plan.n_chunks * plan.chunk
    assert plan.blocks == pairs * plan.n_chunks
    assert plan.waves == -(-plan.blocks // slots)
    if pairs <= slots:
        assert plan.waves == 1
        # one 64-slot step smaller would need more chunks than a wave holds
        if plan.chunk > tk.MIN_CHUNK:
            smaller = plan.chunk - tk.MIN_CHUNK
            assert pairs * -(-S // smaller) > slots
    else:
        assert plan.n_chunks == 1
    if (B, S, Hkv) == (8, 32768, 2):
        assert plan.blocks >= 0.9 * slots


@pytest.mark.parametrize("S,n_chunks", [(32768, 32), (32768, 24), (4096, 7),
                                        (1000, 16), (33, 1), (200, 300)])
def test_device_chunks_fit_the_scratch(S, n_chunks):
    """The kernel splits each cache_len in 1..S into chunks of a multiple
    of 64 slots that cover it, never more than the n_chunks partials the
    wrapper allocates."""
    for length in range(1, S + 1):
        chunk = tk.chunk_for(length, n_chunks)
        assert chunk % tk.MIN_CHUNK == 0 and chunk >= tk.MIN_CHUNK
        used = -(-length // chunk)
        assert used <= n_chunks and used * chunk >= length


def test_split_plan_rejects_an_empty_card():
    with pytest.raises(ValueError, match="no split plan"):
        tk.split_plan(8, 32768, 2, 132, 0)
