"""The streaming aggregation service: repro_torch.serve and the masked
partial-fill forms against repro.serve and repro.agg.aggregate_masked, on
the CPU.

* The masked forms: every registered rule is servable; a buffer and its
  dense prefix aggregate byte for byte alike under both masked backends
  ("sort": the rule's reference on the prefix; "bisect": one
  order-statistics call on the prefix, the kernel's plain version here);
  parity with the reference's masked forms per backend (``median``
  bit-equal, the rest within atol = rtol = 2e-5, the reference's own
  masked-versus-reference tolerance in tests/test_serve.py).
* The pytree wire: leaf order, leaf paths and leaf dims equal the
  reference's; noise, corruption and masked aggregation per leaf.
* The ring buffer, the flush policy (decisions and refusals equal the
  reference's over a grid) and the service's behaviour, as
  tests/test_serve.py checks the reference's. The deadline is tested
  against a patched clock, not by sleeping: the reference's sleeping test
  fails when its first call takes longer than the deadline.
* The service against the reference's on the same updates and the
  reference's own noise draws: thetas within atol = rtol = 2e-5, ledger
  sigmas and failure probabilities bit-equal.
* The launcher (``python -m repro_torch.launch.serve``) and its refusals.

Values are drawn by numpy from a seed; C = 12, P = 5 and the fills are
tests/test_serve.py's.
"""
import dataclasses
import gc
import os
import subprocess
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import agg as jagg
from repro.core import dp as jdp
from repro.core import transport as jtransport
from repro.core.keys import stream_key
from repro.serve import AggregationService as JService
from repro.serve import FlushPolicy as JPolicy
from repro.serve import ServeConfig as JConfig
from repro_torch import agg
from repro_torch.core import dp, keys, transport
from repro_torch.interop import serve_noise_from_numpy, tree_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serve import (AggregationService, FlushPolicy, RingBuffer,
                               ServeConfig)
from torch_threads import share_the_cores  # noqa: F401 (autouse)

C, P = 12, 5
FILLS = (1, 2, 5, 6, 11, 12)
METHODS = sorted(agg.registered())
#: (rule, masked backend) for every form the registry has
FORMS = [(m, "sort") for m in METHODS] + \
    [(m, "bisect") for m in METHODS
     if agg.get_aggregator(m).masked_bisect is not None]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(seed=0, rows=C, p=P):
    return np.random.default_rng(seed).standard_normal(
        (rows, p)).astype(np.float32)


def _scale(method):
    return 0.7 if agg.get_aggregator(method).needs_scale else None


def _masked(vals, k, method, backend):
    return agg.aggregate_masked(vals, k, method=method, scale=_scale(method),
                                backend=backend)


# ------------------------------------------------------ the masked forms

@pytest.mark.parametrize("method", METHODS)
def test_every_registered_rule_is_servable(method):
    assert agg.has_masked(method)
    assert jagg.has_masked(method)
    assert (agg.get_aggregator(method).masked_bisect is None) == \
        (jagg.get_aggregator(method).masked_bisect is None)


@pytest.mark.parametrize("method,backend", FORMS)
def test_masked_buffer_equals_dense_prefix(method, backend):
    """A buffer with a stale tail and its dense prefix aggregate to the
    same bytes at every fill."""
    vals = torch.from_numpy(_np(1))
    for k in FILLS:
        buffered = _masked(vals, k, method, backend)
        dense = _masked(vals[:k].clone(), k, method, backend)
        assert torch.equal(buffered, dense), f"{method} fill={k}"


@pytest.mark.parametrize("method,backend", FORMS)
def test_masked_matches_reference(method, backend):
    vals = _np(3)
    sc = _scale(method)
    jsc = None if sc is None else jnp.full((P,), sc)
    ref = jax.jit(lambda v, f: jagg.aggregate_masked(
        v, f, method=method, scale=jsc, backend=backend))
    for k in FILLS:
        want = np.asarray(ref(jnp.asarray(vals), jnp.int32(k)))
        got = _masked(torch.from_numpy(vals), k, method, backend).numpy()
        if method == "median":
            np.testing.assert_array_equal(got, want, err_msg=f"fill={k}")
        else:
            np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5,
                                       err_msg=f"{method} at fill={k}")


def test_masked_median_bitwise_equals_reference_median():
    vals = torch.from_numpy(_np(7))
    for k in range(1, C + 1):
        assert torch.equal(_masked(vals, k, "median", "sort"),
                           agg.median_agg(vals[:k], axis=0)), f"fill={k}"


def test_masked_backend_none_is_sort_on_the_cpu():
    vals = torch.from_numpy(_np(8))
    for method in ("median", "dcq_mad"):
        assert torch.equal(_masked(vals, 7, method, None),
                           _masked(vals, 7, method, "sort"))


def test_masked_keeps_payload_shape_and_dtype():
    vals = torch.from_numpy(_np(9, p=6)).reshape(C, 3, 2).double()
    out = agg.aggregate_masked(vals, 5, method="dcq_mad")
    assert out.shape == (3, 2) and out.dtype == torch.float64
    moved = agg.aggregate_masked(vals.movedim(0, 2), 5, method="median",
                                 axis=2)
    assert torch.equal(moved, agg.aggregate_masked(vals, 5, "median"))


def test_masked_errors():
    vals = torch.from_numpy(_np())
    with pytest.raises(ValueError, match="scale"):
        agg.aggregate_masked(vals, 3, method="dcq")
    with pytest.raises(ValueError, match="trim"):
        agg.aggregate_masked(vals, 3, method="trimmed", trim_beta=0.5)
    for bad in (0, C + 1):
        with pytest.raises(ValueError, match="fill"):
            agg.aggregate_masked(vals, bad, method="median")
    with pytest.raises(TypeError, match="fill"):
        agg.aggregate_masked(vals, torch.tensor(3), method="median")
    with pytest.raises(ValueError, match="bisect"):
        agg.aggregate_masked(vals, 3, method="trimmed", backend="bisect")
    with pytest.raises(ValueError, match="unknown masked backend"):
        agg.aggregate_masked(vals, 3, method="median", backend="pallas")


# -------------------------------------------------------- the pytree wire

def _nested(rng, lead=()):
    def a(*shape):
        return rng.standard_normal(lead + shape).astype(np.float32)
    return {"w": a(3, 2), "b": a(3),
            "layers": [{"w_q": a(2, 2), "norm": a(4)},
                       {"w_q": a(2, 2), "norm": a(4)}],
            "pair": (a(1), a(2, 1, 3))}


def test_leaf_paths_and_dims_match_reference():
    tree = _nested(np.random.default_rng(0))
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = tree_from_numpy(tree, device="cpu")
    assert transport.leaf_paths(tt) == jtransport.leaf_paths(jt)
    assert transport.leaf_paths(torch.zeros(3)) == \
        jtransport.leaf_paths(jnp.zeros(3)) == ["theta"]
    assert transport.tree_leaves(transport.tree_leaf_dims(tt)) == \
        jax.tree_util.tree_leaves(jtransport.tree_leaf_dims(jt))
    assert transport.tree_size(tt) == jtransport.tree_size(jt)
    assert transport.tree_size(tt, machine_axis=True) == \
        jtransport.tree_size(jt, machine_axis=True)
    for a, b in zip(transport.tree_leaves(tt), jax.tree_util.tree_leaves(jt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = transport.tree_unflatten(*reversed(transport.tree_flatten(tt)))
    assert transport.leaf_paths(back) == transport.leaf_paths(tt)
    assert isinstance(back["pair"], tuple)


def test_tree_walks_leave_no_reference_cycle():
    """Flattening and rebuilding a tree must not keep its leaves alive once
    the caller drops them: a flush would otherwise hold a model's worth of
    device memory until the cyclic collector ran."""
    gc.disable()
    try:
        leaf = torch.zeros(3)
        ref = weakref.ref(leaf)
        tree = {"a": [leaf, (torch.ones(1),)], "b": torch.ones(2)}
        out = transport.tree_map(lambda x: x, tree)
        transport.leaf_paths(tree)
        del leaf, tree, out
        assert ref() is None
    finally:
        gc.enable()


def test_tree_axpy_and_tree_from_numpy_dtypes():
    x = {"a": torch.ones(2), "b": [torch.full((3,), 2.0)]}
    y = transport.tree_axpy(-0.5, x, x)
    assert torch.equal(y["b"][0], torch.ones(3))
    bf = jnp.arange(4, dtype=jnp.bfloat16) / 3
    got = tree_from_numpy({"h": np.asarray(bf), "i": np.arange(3)},
                          device="cpu")
    assert got["h"].dtype == torch.bfloat16 and got["i"].dtype == torch.int64
    np.testing.assert_array_equal(got["h"].float().numpy(),
                                  np.asarray(bf, np.float32))


def test_wire_noise_and_corrupt_on_trees_match_reference():
    tree = _nested(np.random.default_rng(1), lead=(C,))
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = tree_from_numpy(tree, device="cpu")
    key = jax.random.PRNGKey(3)
    leaves = jax.tree_util.tree_leaves(jt)
    zs = [np.asarray(jax.random.normal(k, x.shape, x.dtype))
          for k, x in zip(jtransport._leaf_keys(key, len(leaves)), leaves)]
    sig = jax.tree_util.tree_map(lambda x: 0.1 * x.shape[-1], jt)
    tsig = transport.tree_unflatten(transport.tree_flatten(tt)[1],
                                    jax.tree_util.tree_leaves(sig))
    want = jtransport.wire_noise(key, jt, sig)
    got = transport.wire_noise(serve_noise_from_numpy(zs, tree_from_numpy(
        jax.tree_util.tree_map(lambda x: np.asarray(x[0]), tree),
        device="cpu"), device="cpu"), tt, tsig)
    for a, b in zip(transport.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    drawn = transport.wire_noise(torch.Generator().manual_seed(0), tt, 0.5)
    assert transport.leaf_paths(drawn) == transport.leaf_paths(tt)
    mask = np.arange(C) < 3
    want = jtransport.wire_corrupt(None, jt, jnp.asarray(mask), "signflip")
    got = transport.wire_corrupt(None, tt, torch.from_numpy(mask),
                                 "signflip")
    for a, b in zip(transport.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("method", ["median", "dcq_mad", "trimmed"])
def test_wire_aggregate_fill_routes_pytrees(method):
    """wire_aggregate(tree, fill=k) is the masked entry per leaf, and
    matches the reference's per leaf."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.standard_normal((C, 3, 2)).astype(np.float32),
            "b": rng.standard_normal((C,)).astype(np.float32)}
    tt = tree_from_numpy(tree, device="cpu")
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    wired = jax.jit(lambda t, f: jtransport.wire_aggregate(
        t, method, fill=f, backend="sort"))
    for k in (1, 6, C):
        out = transport.wire_aggregate(tt, method, fill=k)
        ref = wired(jt, jnp.int32(k))
        for name in ("w", "b"):
            assert torch.equal(out[name], agg.aggregate_masked(
                tt[name], k, method=method))
            np.testing.assert_allclose(out[name].numpy(),
                                       np.asarray(ref[name]), rtol=2e-5,
                                       atol=2e-5)
    flat = torch.from_numpy(tree["w"])
    assert torch.equal(transport.wire_aggregate(flat, method, fill=4),
                       agg.aggregate_masked(flat, 4, method=method))


def test_wire_aggregate_on_a_tree_without_fill():
    rng = np.random.default_rng(6)
    tree = {"w": rng.standard_normal((9, 3, 2)).astype(np.float32),
            "b": rng.standard_normal((9,)).astype(np.float32)}
    got = transport.wire_aggregate(tree_from_numpy(tree, device="cpu"),
                                   "dcq", scale={"w": 0.5, "b": 1.0})
    want = jtransport.wire_aggregate(
        jax.tree_util.tree_map(jnp.asarray, tree), "dcq",
        scale={"w": 0.5, "b": 1.0}, backend="reference")
    for name in ("w", "b"):
        assert got[name].shape == want[name].shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=2e-5, atol=2e-5)


def test_tree_sigma_and_spend_tree_match_reference():
    dims = {"w": 6, "b": 3, "layers": [16, 4096]}
    for tail in ("subexp", "subgauss"):
        got = dp.tree_mean_sigma(dims, 200, 2.0, 0.5, 1e-6, tail)
        want = jdp.tree_mean_sigma(dims, 200, 2.0, 0.5, 1e-6, tail)
        assert transport.tree_leaves(got) == jax.tree_util.tree_leaves(want)
    sig = dp.tree_mean_sigma(dims, 200, 2.0, 0.5, 1e-6)
    ta, ja = dp.PrivacyAccountant(), jdp.PrivacyAccountant()
    for acct in (ta, ja):
        acct.spend_tree("serve round 0", 0.5, 1e-6, sig)
        acct.spend("other", 0.5, 1e-6, 1.0)
    for a, b in zip(ta.records, ja.records):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ta.summary() == ja.summary()


def test_stream_seeds_do_not_collide():
    seeds = {keys.stream_seed(s, st, i) for s in range(20)
             for st in keys.STREAMS for i in (None, 0, 1, 2)}
    assert len(seeds) == 20 * len(keys.STREAMS) * 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
    with pytest.raises(ValueError, match="unknown stream"):
        keys.stream_seed(0, "nope")


# ------------------------------------------------------------ ring buffer

def _rows(seed, rows=C):
    return torch.from_numpy(_np(seed, rows=rows))


def test_ring_buffer_prefix_and_wrap():
    buf = RingBuffer(torch.zeros(P), capacity=4, device="cpu")
    rows = _rows(2, rows=6)
    for i in range(4):
        assert buf.push(rows[i]) == i
    assert buf.fill == 4 and buf.full
    assert buf.push(rows[4]) == 0          # the 5th write wraps to slot 0
    assert buf.fill == 4
    assert torch.equal(buf.arrays[0], rows[4])
    assert torch.equal(buf.arrays[1:], rows[1:4])
    buf.reset()
    assert buf.fill == 0 and not buf.full
    assert torch.equal(buf.arrays[1:], rows[1:4])   # stale rows stay


def test_ring_buffer_block_write_needs_room():
    tmpl = {"a": torch.zeros(P), "b": torch.zeros((2, 1))}
    buf = RingBuffer(tmpl, capacity=8, block=4, device="cpu")
    rows = {"a": _rows(4, rows=8),
            "b": torch.from_numpy(_np(5, rows=8, p=2)).reshape(8, 2, 1)}
    ptr = buf.arrays["a"].data_ptr()
    buf.push_block(rows, 0)
    buf.push_block(rows, 4)
    assert buf.full and buf.arrays["a"].data_ptr() == ptr   # in place
    with pytest.raises(ValueError, match="room"):
        buf.push_block(rows, 0)
    assert torch.equal(buf.arrays["a"], rows["a"])
    assert torch.equal(buf.arrays["b"], rows["b"])
    assert RingBuffer(torch.zeros(1), 3, block=64, device="cpu").block == 3
    with pytest.raises(ValueError, match="capacity"):
        RingBuffer(torch.zeros(1), 0, device="cpu")


# ----------------------------------------------------------- flush policy

POLICIES = [dict(capacity_frac=f, max_delay_s=d, min_fill=n)
            for f in (None, 0.25, 0.5, 1.0) for d in (None, 0.0, 1.0)
            for n in (1, 3)]


@pytest.mark.parametrize("kw", POLICIES)
def test_flush_policy_decides_as_the_reference(kw):
    ours, ref = FlushPolicy(**kw), JPolicy(**kw)
    for cap in (1, 4, 12):
        assert ours.capacity_trigger(cap) == ref.capacity_trigger(cap)
        for fill in range(cap + 1):
            for age in (0.0, 0.5, 1.0, 5.0):
                assert ours.should_flush(fill, cap, age) == \
                    ref.should_flush(fill, cap, age), (cap, fill, age)


def test_flush_policy_validation_as_the_reference():
    for bad in (dict(capacity_frac=0.0), dict(capacity_frac=1.5),
                dict(max_delay_s=-1.0), dict(min_fill=0),
                dict(backpressure="drop")):
        with pytest.raises(ValueError) as ours:
            FlushPolicy(**bad)
        with pytest.raises(ValueError) as ref:
            JPolicy(**bad)
        assert str(ours.value) == str(ref.value)


# ------------------------------------------------------------ the service

def _svc(theta, policy=None, **kw):
    return AggregationService(theta, ServeConfig(**kw), policy=policy,
                              device="cpu")


def test_service_multi_round():
    svc = _svc(torch.zeros(P), method="dcq_mad", capacity=C, ingest_block=4,
               lr=0.5, seed=2)
    for r in range(3):
        assert svc.submit_many(_rows(20 + r)) == C
    for row in _rows(9, rows=5):
        svc.submit(row)
    assert svc.flush() is not None
    assert svc.round_idx == 4
    assert [h["fill"] for h in svc.history] == [C, C, C, 5]
    assert all(h["flush_s"] >= 0 and h["latency_s"] >= h["flush_s"]
               for h in svc.history)


def test_service_round_matches_dense_aggregation():
    """One served round is the dense masked aggregate, and theta moves by
    exactly -lr * aggregate."""
    theta = torch.zeros(P)
    svc = _svc(theta, method="median", capacity=C, lr=0.25)
    ups = _rows(11)
    svc.submit_many(ups)
    want = agg.aggregate_masked(ups, C, method="median")
    assert torch.equal(svc.theta, -0.25 * want)
    assert svc.theta is theta                      # updated in place


def test_service_ledger_records_every_round():
    tree = {"w": torch.zeros((3, 2)), "b": torch.zeros(3)}
    svc = _svc(tree, method="median", capacity=6, eps=0.5, delta=1e-6,
               dp_n=200, seed=1)
    ups = {"w": _rows(0, rows=6)[:, :1].reshape(6, 1, 1)
           * torch.ones((6, 3, 2)), "b": torch.from_numpy(_np(1, 6, 3))}
    for _ in range(3):
        svc.submit_many(ups)
    assert svc.round_idx == 3
    assert len(svc.ledger) == 3 * 2
    assert {e["transmission"] for e in svc.ledger} == \
        {f"serve round {r}" for r in range(3)}
    assert all(e["eps"] == 0.5 and e["sigma"] > 0 and e["noise"]
               for e in svc.ledger)
    eps_tot, delta_tot = svc.accountant.total_basic()
    assert eps_tot == pytest.approx(1.5)
    assert delta_tot == pytest.approx(3e-6)
    assert [r.per_leaf[0]["leaf"] for r in svc.accountant.records] == \
        ["b"] * 3


def test_service_noiseless_ledger_still_records():
    svc = _svc(torch.zeros(P), capacity=4)
    svc.submit_many(_rows(2, rows=4))
    assert len(svc.ledger) == 1
    assert svc.ledger[0]["eps"] == 0.0 and not svc.ledger[0]["noise"]
    assert not svc.accountant.records


def test_service_noise_draws_repeat_per_seed_and_round():
    def run(seed):
        svc = _svc(torch.zeros(P), capacity=4, eps=1.0, seed=seed)
        for r in range(2):
            svc.submit_many(_rows(r, rows=4))
        return svc.theta
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


def test_service_deadline_flush_via_poll(monkeypatch):
    """The deadline on a patched clock, not by sleeping: the reference's
    counterpart (tests/test_serve.py) sleeps 0.25 s against a 0.2 s
    deadline and fails on timing when its first submit, which compiles,
    takes longer than the deadline under parallel test workers."""
    now = [100.0]
    monkeypatch.setattr("repro_torch.serve.service.time.perf_counter",
                        lambda: now[0])
    pol = FlushPolicy(capacity_frac=None, max_delay_s=0.2, min_fill=2)
    rows = _rows(0, rows=3)
    svc = _svc(torch.zeros(P), pol, capacity=C)
    svc.submit(rows[0])
    now[0] += 0.25
    assert svc.poll() is None            # min_fill floors the deadline
    svc.submit(rows[1])                  # the overdue arrival flushes
    assert svc.round_idx == 1 and svc.history[-1]["fill"] == 2
    assert svc.history[-1]["latency_s"] == pytest.approx(0.25)
    svc = _svc(torch.zeros(P), pol, capacity=C)
    svc.submit(rows[0])
    now[0] += 0.1
    svc.submit(rows[1])
    assert svc.round_idx == 0            # age < deadline at ingest
    now[0] += 0.05
    assert svc.poll() is None            # still inside the deadline
    now[0] += 0.15
    assert svc.poll() is not None        # deadline fires on the partial
    assert svc.history[-1]["fill"] == 2
    assert svc.poll() is None            # empty buffer: nothing to serve


def test_service_backpressure_reject():
    pol = FlushPolicy(capacity_frac=None, backpressure="reject")
    svc = _svc(torch.zeros(P), pol, capacity=4)
    assert svc.submit_many(_rows(3, rows=6)) == 4
    assert svc.rejected == 2 and svc.fill == 4
    assert svc.flush() is not None


def test_service_backpressure_overwrite():
    pol = FlushPolicy(capacity_frac=None, backpressure="overwrite")
    svc = _svc(torch.zeros(P), pol, capacity=4)
    rows = _rows(6, rows=6)
    for row in rows:
        assert svc.submit(row)
    assert svc.rejected == 0 and svc.fill == 4
    assert torch.equal(svc.buffer.arrays, rows[[4, 5, 2, 3]])


def test_service_min_fill_blocks_explicit_flush():
    pol = FlushPolicy(capacity_frac=None, min_fill=3)
    svc = _svc(torch.zeros(P), pol, capacity=C)
    svc.submit(_rows(0, rows=1)[0])
    assert svc.flush() is None and svc.round_idx == 0
    svc.submit_many(_rows(1, rows=2))
    assert svc.flush() is not None and svc.round_idx == 1


def test_service_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AggregationService(torch.zeros(P))


# ------------------------------------------- the service against the JAX one

def _ref_noise(seed, r, theta):
    """The reference service's round-r standard normals, per leaf."""
    key = jax.random.fold_in(stream_key(seed, "serve"), r)
    leaves = jax.tree_util.tree_leaves(theta)
    return [np.asarray(jax.random.normal(k, (C,) + x.shape, x.dtype))
            for k, x in zip(jtransport._leaf_keys(key, len(leaves)), leaves)]


@pytest.mark.parametrize("backend", ["sort", "bisect"])
@pytest.mark.parametrize("kind", ["flat", "tree"])
def test_service_matches_reference(kind, backend):
    """Three rounds (the last partial), eps = 0.5, the reference's updates
    and noise: thetas within 2e-5, ledgers bit-equal."""
    rng = np.random.default_rng(40)
    theta = np.zeros(P, np.float32) if kind == "flat" else \
        {"w": np.zeros((3, 2), np.float32), "b": np.zeros(3, np.float32)}
    kw = dict(method="dcq_mad", capacity=C, eps=0.5, lr=0.5, seed=4,
              ingest_block=4, masked_backend=backend)
    pol = dict(capacity_frac=None)
    jtheta = jax.tree_util.tree_map(jnp.asarray, theta)
    ref = JService(jtheta, JConfig(**kw), policy=JPolicy(**pol))
    svc = AggregationService(tree_from_numpy(theta, device="cpu"),
                             ServeConfig(**kw), policy=FlushPolicy(**pol),
                             device="cpu")
    for r, n in enumerate((C, C, 7)):
        ups = jax.tree_util.tree_map(
            lambda x: rng.standard_normal((n,) + x.shape).astype(np.float32),
            theta)
        ref.submit_many(jax.tree_util.tree_map(jnp.asarray, ups))
        svc.submit_many(tree_from_numpy(ups, device="cpu"))
        ref.flush()
        svc.flush(noise=serve_noise_from_numpy(
            _ref_noise(4, r, jtheta), svc.theta, device="cpu"))
    assert [h["fill"] for h in svc.history] == \
        [h["fill"] for h in ref.history] == [C, C, 7]
    for a, b in zip(transport.tree_leaves(svc.theta),
                    jax.tree_util.tree_leaves(ref.theta)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)
    assert svc.ledger == ref.ledger
    assert svc.accountant.summary() == ref.accountant.summary()


# ------------------------------------------------------------ the launcher

def test_launcher_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--config",
         "glm4-9b", "--machines", "16", "--rounds", "3", "--dropout", "0.25",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=REPO, timeout=300, check=False)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("fill    12/16") == 3
    assert "[serve] 3 rounds, 36 updates" in res.stdout


@pytest.mark.parametrize("argv,code", [
    ([], 1),                     # default --arch xlstm-125m: the card
    (["--config", "gpt-x"], 2),                         # unknown arch
    (["--config", "glm4-9b", "--sharded"], 1),      # runs: the card
    (["--config", "glm4-9b"], 1),              # the card, and none here
    (["--config", "llava-next-mistral-7b"], 1),   # runs: the card
    (["--config", "musicgen-medium"], 1),
])
def test_launcher_refusals(argv, code, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        launcher.main(argv)
    assert exc.value.code == code
    err = capsys.readouterr().err
    says = "unknown arch" if "gpt-x" in argv else "device='cpu'"
    assert says in err


def test_launcher_sharded_at_world_1_equals_unsharded(capsys):
    """``--sharded`` in one process is a world of 1: the same fills,
    ledger and served theta as the unsharded run, bit for bit."""
    argv = ["--config", "glm4-9b", "--machines", "8", "--rounds", "2",
            "--agg", "dcq_mad", "--eps", "1", "--dropout", "0.25",
            "--ingest-block", "4", "--device", "cpu"]
    one = launcher.main(argv)
    capsys.readouterr()
    sharded = launcher.main(argv + ["--sharded"])
    assert "[serve] ring buffer sharded over 1 device(s)" in \
        capsys.readouterr().out
    assert [h["fill"] for h in sharded.history] == [6, 6]
    assert sharded.ledger == one.ledger
    for a, b in zip(transport.tree_leaves(sharded.theta),
                    transport.tree_leaves(one.theta)):
        assert torch.equal(a, b)


def test_launcher_in_process_with_an_attack():
    svc = launcher.main(["--config", "glm4-9b", "--machines", "8",
                         "--rounds", "2", "--agg", "median", "--eps", "1",
                         "--byzantine", "0.25", "--attack", "signflip",
                         "--ingest-block", "4", "--device", "cpu"])
    assert [h["fill"] for h in svc.history] == [8, 8]
    assert len(svc.ledger) == 2 * 12 and len(svc.accountant.records) == 2
    assert all(bool(torch.isfinite(t).all())
               for t in transport.tree_leaves(svc.theta))


def test_launcher_ledger_matches_the_reference_leaf_for_leaf():
    """Both launchers serve Model.init's tree (the layer stack on a leading
    L axis): 12 leaves per round for the reduced glm4-9b, with the same
    paths, dims and per-leaf sigmas. (The ledger does not depend on the
    aggregation rule; median keeps the reference's run short.)"""
    from repro.launch import serve as jlauncher
    argv = ["--config", "glm4-9b", "--machines", "8", "--rounds", "2",
            "--eps", "1", "--agg", "median"]
    ref = jlauncher.main(argv)
    svc = launcher.main(argv + ["--device", "cpu"])
    keys = ("transmission", "leaf", "dim", "sigma")
    want = [tuple(e[k] for k in keys) for e in ref.ledger]
    got = [tuple(e[k] for k in keys) for e in svc.ledger]
    assert len(got) == 2 * 12 and got == want
    assert "layers/attn/w_q" in {e["leaf"] for e in svc.ledger}
