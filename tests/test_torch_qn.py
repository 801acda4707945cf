"""The quasi-Newton pytree engine of repro_torch against the JAX reference,
on the CPU: the tree algebra, the BFGS and L-BFGS forms, the per-leaf tree
calibration and its ledger, and ``protocol_tree_rounds`` on the
reference's own toy problems and draws.

Inputs are drawn by numpy from a seed; the engine's noise is the
reference's own ``jax.random`` draws (``split(key, 16)``, then one key per
leaf, then ``normal(k, (m, *leaf))``), rebuilt here and handed across,
since torch cannot reproduce ``jax.random``. The trainer, the launcher and
the checkpoint are in tests/test_torch_qn_train.py.

Tolerances: f32 tree algebra exact (one rounding per element; the dot a
sum in another order: rtol 1e-6); bf16 within one bf16 rounding of the
result's scale; BFGS forms rtol 1e-6; sigmas and ledgers bit-equal; the
engine atol = rtol = 1e-5 (f32 sums in another order through five
rounds), with the reference's DCQ knots handed to the port (the
packages' float32 knots differ by up to 3 ulp, ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.agg import reference as jagg_ref
from repro.configs import get_config as jget_config
from repro.configs.base import TreeProtocolConfig as JTreeCfg
from repro.core import bfgs as jbfgs
from repro.core import dp as jdp
from repro.core import transport as jtransport
from repro.core.protocol import protocol_tree_rounds as jrounds
from repro.models.model import Model as JModel
from repro_torch import privacy
from repro_torch.agg import reference as tagg_ref
from repro_torch.configs.base import TreeProtocolConfig
from repro_torch.core import bfgs, dp, transport
from repro_torch.core.protocol import protocol_tree_rounds
from repro_torch.interop import (lbfgs_memory_from_reference,
                                 tree_config_from_reference,
                                 tree_draws_from_numpy)
from torch_threads import share_the_cores  # noqa: F401 (autouse)

ATOL = RTOL = 1e-5
#: the reference's tree transmissions' (noise, attack) key slots of the
#: 16-way split (core/protocol.py protocol_tree_rounds)
SLOTS = {"R1 theta": (0, 1), "R2 grad": (2, 3), "R3 newton-dir": (6, 7),
         "R4 grad-diff": (8, 9), "R5 bfgs-dir": (10, 11)}


def reference_draws(key, theta, m):
    """The reference engine's draws for ``key``: ``(noise, attack_noise)``,
    each ``{transmission: tree of normals (m, *leaf)}`` as numpy."""
    keys = jax.random.split(key, 16)
    leaves, treedef = jax.tree_util.tree_flatten(theta)

    def tree(k):
        ks = jtransport._leaf_keys(k, len(leaves))
        return jax.tree_util.tree_unflatten(treedef, [
            np.asarray(jax.random.normal(kk, (m,) + x.shape, x.dtype))
            for kk, x in zip(ks, leaves)])
    return ({name: tree(keys[a]) for name, (a, _) in SLOTS.items()},
            {name: tree(keys[b]) for name, (_, b) in SLOTS.items()})


@pytest.fixture
def ref_knots(monkeypatch):
    """The reference's float32 DCQ knots in the port's plain DCQ forms."""
    knots = np.asarray(jagg_ref.quantile_knots(10))
    monkeypatch.setattr(tagg_ref, "quantile_knots", lambda K, device=None:
                        torch.tensor(knots, device=device))


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.float32):
    return torch.tensor(np.asarray(x, np.float32), dtype=dtype)


# ----------------------------------------------------------- tree algebra

def _trees(dtype, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 5), "layers": {"a": (2, 4), "b": (7,)}, "s": ()}

    def draw():
        return {k: ({kk: rng.standard_normal(v).astype(np.float32)
                     for kk, v in s.items()} if isinstance(s, dict)
                    else rng.standard_normal(s).astype(np.float32))
                for k, s in shapes.items()}
    a, b = draw(), draw()
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    to_j = lambda t: jax.tree_util.tree_map(lambda x: jnp.asarray(x, jd), t)
    to_t = lambda t: transport.tree_map(lambda x: _t(x, td), t)
    return (to_j(a), to_j(b)), (to_t(a), to_t(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_algebra_matches_reference(dtype):
    (ja, jb), (ta, tb) = _trees(dtype)
    bf16 = dtype == "bfloat16"
    tol = dict(rtol=2.0 ** -7, atol=2.0 ** -7) if bf16 else \
        dict(rtol=0, atol=0)
    cases = [(jtransport.tree_add(ja, jb), transport.tree_add(ta, tb)),
             (jtransport.tree_sub(ja, jb), transport.tree_sub(ta, tb)),
             (jtransport.tree_scale(-0.3, ja),
              transport.tree_scale(-0.3, ta)),
             (jtransport.tree_axpy(0.7, ja, jb),
              transport.tree_axpy(0.7, ta, tb))]
    for want, got in cases:
        assert transport.leaf_paths(got) == jtransport.leaf_paths(want)
        for w, g in zip(jax.tree_util.tree_leaves(want),
                        transport.tree_leaves(got)):
            assert g.dtype == (torch.bfloat16 if bf16 else torch.float32)
            scale = max(1.0, float(np.abs(_np(w)).max()))
            np.testing.assert_allclose(g.float().numpy(), _np(w),
                                       rtol=tol["rtol"],
                                       atol=tol["atol"] * scale)
    want, got = jtransport.tree_dot(ja, jb), transport.tree_dot(ta, tb)
    assert got.dim() == 0 and str(got.dtype).endswith(str(want.dtype))
    np.testing.assert_allclose(float(got), float(want),
                               rtol=2.0 ** -6 if bf16 else 1e-6)


# ------------------------------------------------------------------ BFGS

def _spd(rng, p):
    a = rng.standard_normal((p, p))
    return (a @ a.T + p * np.eye(p)).astype(np.float32)


def test_bfgs_inverse_update_and_dir_product_match_reference():
    rng = np.random.default_rng(1)
    p = 6
    h = np.linalg.inv(_spd(rng, p)).astype(np.float32)
    s = rng.standard_normal(p).astype(np.float32)
    y = (s + 0.1 * rng.standard_normal(p)).astype(np.float32)
    g = rng.standard_normal(p).astype(np.float32)
    want = jbfgs.bfgs_inverse_update(jnp.asarray(h), jnp.asarray(s),
                                     jnp.asarray(y))
    got = bfgs.bfgs_inverse_update(_t(h), _t(s), _t(y))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                               atol=1e-7)
    # the secant equation H+ y = s
    np.testing.assert_allclose((got @ _t(y)).numpy(), s, rtol=1e-4,
                               atol=1e-5)
    for rho_term in (True, False):
        want = jbfgs.bfgs_dir_product(lambda x: jnp.asarray(h) @ x,
                                      jbfgs.make_v(jnp.asarray(s),
                                                   jnp.asarray(y)),
                                      jnp.asarray(g), rho_term=rho_term)
        got = bfgs.bfgs_dir_product(lambda x: _t(h) @ x,
                                    bfgs.make_v(_t(s), _t(y)), _t(g),
                                    rho_term=rho_term)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                                   atol=1e-7)


def _pairs(rng, p, k):
    out = []
    for _ in range(k):
        s = rng.standard_normal(p).astype(np.float32)
        out.append((s, (s + 0.2 * rng.standard_normal(p)).astype(
            np.float32)))
    return out


@pytest.mark.parametrize("hist", [1, 3, 5])
@pytest.mark.parametrize("pushes", ["0", "1", "hist", "hist+2"])
def test_lbfgs_two_loop_and_gamma_match_reference(hist, pushes):
    """Flat and tree two-loop and the BB gamma at every fill of the
    memory: empty, one pair, full, and rolled past full."""
    k = {"0": 0, "1": 1, "hist": hist, "hist+2": hist + 2}[pushes]
    rng = np.random.default_rng(10 * hist + k)
    p = 7
    jm, tm = jbfgs.LBFGSMemory.init(hist, p), bfgs.LBFGSMemory.init(hist, p)
    jt = jbfgs.LBFGSMemory.init_like(hist, {"a": jnp.zeros(4),
                                            "b": jnp.zeros(3)})
    tt = bfgs.LBFGSMemory.init_like(hist, {"a": torch.zeros(4),
                                           "b": torch.zeros(3)})
    for s, y in _pairs(rng, p, k):
        jm, tm = jm.push(jnp.asarray(s), jnp.asarray(y)), tm.push(_t(s),
                                                                  _t(y))
        jt = jt.push({"a": jnp.asarray(s[:4]), "b": jnp.asarray(s[4:])},
                     {"a": jnp.asarray(y[:4]), "b": jnp.asarray(y[4:])})
        tt = tt.push({"a": _t(s[:4]), "b": _t(s[4:])},
                     {"a": _t(y[:4]), "b": _t(y[4:])})
    assert int(tm.count) == int(jm.count) == k
    np.testing.assert_array_equal(tm.s_hist.numpy(), _np(jm.s_hist))
    np.testing.assert_array_equal(tm.y_hist.numpy(), _np(jm.y_hist))
    g = rng.standard_normal(p).astype(np.float32)
    for gamma in (1.0, 0.7):
        want = jbfgs.lbfgs_two_loop(jm, jnp.asarray(g), gamma=gamma)
        got = bfgs.lbfgs_two_loop(tm, _t(g), gamma=gamma)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6,
                                   atol=1e-6)
        want = jbfgs.lbfgs_two_loop_tree(
            jt, {"a": jnp.asarray(g[:4]), "b": jnp.asarray(g[4:])},
            gamma=gamma)
        got = bfgs.lbfgs_two_loop_tree(tt, {"a": _t(g[:4]),
                                            "b": _t(g[4:])}, gamma=gamma)
        for key in "ab":
            np.testing.assert_allclose(got[key].numpy(), _np(want[key]),
                                       rtol=1e-6, atol=1e-6)
    for jj, tx in ((jm, tm), (jt, tt)):
        want, got = jbfgs.lbfgs_gamma(jj), bfgs.lbfgs_gamma(tx)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if k == 0:          # the empty memory is the identity, gamma 1
        np.testing.assert_array_equal(
            bfgs.lbfgs_two_loop(tm, _t(g)).numpy(), g)
        assert float(bfgs.lbfgs_gamma(tm)) == 1.0


def test_lbfgs_two_loop_tree_matches_flat():
    """The reference's own test with the port on both sides: one flat
    leaf gives the flat form exactly; a vector split over two leaves
    gives it within rounding (the dots sum over leaves)."""
    rng = np.random.default_rng(11)
    p, hist = 6, 4
    flat = bfgs.LBFGSMemory.init(hist, p)
    one = bfgs.LBFGSMemory.init_like(hist, {"theta": torch.zeros(p)})
    two = bfgs.LBFGSMemory.init_like(hist, {"a": torch.zeros(4),
                                            "b": torch.zeros(2)})
    for s, y in _pairs(rng, p, 3):
        flat = flat.push(_t(s), _t(y))
        one = one.push({"theta": _t(s)}, {"theta": _t(y)})
        two = two.push({"a": _t(s[:4]), "b": _t(s[4:])},
                       {"a": _t(y[:4]), "b": _t(y[4:])})
    g = rng.standard_normal(p).astype(np.float32)
    d_flat = bfgs.lbfgs_two_loop(flat, _t(g), gamma=0.7)
    d_one = bfgs.lbfgs_two_loop_tree(one, {"theta": _t(g)}, gamma=0.7)
    assert torch.equal(d_flat, d_one["theta"])
    d_two = bfgs.lbfgs_two_loop_tree(two, {"a": _t(g[:4]), "b": _t(g[4:])},
                                     gamma=0.7)
    np.testing.assert_allclose(torch.cat([d_two["a"], d_two["b"]]).numpy(),
                               d_flat.numpy(), rtol=1e-5, atol=1e-6)


def test_lbfgs_memory_layout_and_push_order():
    tree = {"w": torch.zeros(2, 3, dtype=torch.bfloat16), "b": torch.zeros(3)}
    mem = bfgs.LBFGSMemory.init_like(3, tree, machines=4)
    assert tuple(mem.s_hist["w"].shape) == (4, 3, 2, 3)
    assert mem.s_hist["w"].dtype == torch.bfloat16
    assert tuple(mem.y_hist["b"].shape) == (4, 3, 3)
    assert mem.count.dtype == torch.int32 and tuple(mem.count.shape) == (4,)
    ref = jbfgs.LBFGSMemory.init_like(3, {"w": jnp.zeros((2, 3)),
                                          "b": jnp.zeros(3)}, machines=4)
    assert ref.count.shape == (4,) and ref.s_hist["w"].shape == (4, 3, 2, 3)
    # push: a roll toward the front, then the new pair in the last slot;
    # the in-place leaf push writes the same history
    single = bfgs.LBFGSMemory.init(3, 2)
    hist = torch.zeros(3, 2)
    for i in range(1, 5):
        v = torch.full((2,), float(i))
        single = single.push(v, -v)
        bfgs.push_leaf_(hist, v)
        assert torch.equal(single.s_hist, hist)
    np.testing.assert_array_equal(single.s_hist[:, 0].numpy(), [2, 3, 4])
    np.testing.assert_array_equal(single.y_hist[:, 0].numpy(), [-2, -3, -4])
    assert int(single.count) == 4
    # machine j's memory is a view
    mem.machine(2).s_hist["b"][0].fill_(1.0)
    assert float(mem.s_hist["b"][2, 0, 0]) == 1.0


def test_lbfgs_memory_from_reference():
    jm = jbfgs.LBFGSMemory.init_like(2, {"w": jnp.ones((2, 3))}, machines=3)
    jm = jax.vmap(lambda mm: mm.push({"w": jnp.full((2, 3), 2.0)},
                                     {"w": jnp.full((2, 3), 3.0)}))(jm)
    tm = lbfgs_memory_from_reference(jax.tree_util.tree_map(np.asarray, jm),
                                     device="cpu")
    assert tm.count.tolist() == [1, 1, 1] and tm.count.dtype == torch.int32
    np.testing.assert_array_equal(tm.s_hist["w"].numpy(),
                                  np.asarray(jm.s_hist["w"]))
    np.testing.assert_array_equal(tm.y_hist["w"].numpy(),
                                  np.asarray(jm.y_hist["w"]))


# --------------------------------------------------- tree DP calibration

@pytest.fixture(scope="module")
def glm_tree():
    """The reduced glm4-9b's parameter tree (shapes only) on both sides."""
    cfg = jget_config("glm4-9b", reduced=True)
    shapes = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    jtree = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                   shapes)
    ttree = transport.tree_map(lambda s: torch.zeros(s.shape),
                               jax.tree_util.tree_map(np.asarray, jtree))
    return jtree, ttree


@pytest.mark.parametrize("accountant", privacy.registered())
def test_tree_calibration_and_ledger_bit_equal(glm_tree, accountant):
    jtree, ttree = glm_tree
    assert dp.TREE_TRANSMISSIONS == jdp.TREE_TRANSMISSIONS
    for n, eps in ((2, 1.0), (120, 10.0)):
        kw = dict(n=n, eps=eps, delta=0.05, accountant=accountant)
        want = jdp.calibrate_tree_sigmas(jtree, **kw)
        got = dp.calibrate_tree_sigmas(ttree, **kw)
        assert list(got) == list(want)
        for name in want:
            assert transport.tree_leaves(got[name]) == \
                jax.tree_util.tree_leaves(want[name])
        want = jdp.tree_spend_ledger(jtree, **kw)
        got = dp.tree_spend_ledger(ttree, **kw)
        assert len(got) == 5 * 12 and got == want


def test_tree_config_from_reference():
    import dataclasses
    ref = JTreeCfg(hist=3, eps=2.0, aggregator="median",
                   gammas=(1.0, 2.0, 3.0, 4.0, 5.0))
    cfg = tree_config_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(TreeProtocolConfig()) == \
        dataclasses.asdict(JTreeCfg())
    with pytest.raises(ValueError, match="unknown"):
        tree_config_from_reference({"nope": 1})


# ------------------------------------------------------- the tree engine

def _least_squares(seed, m, n, p):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n, p)).astype(np.float32)
    y = (X @ np.arange(1.0, p + 1) + 0.01 * rng.standard_normal((m, n))
         ).astype(np.float32)
    return X, y


def _flat_grad(t, b):
    """Least squares on one machine's (X, y), for jnp and torch alike."""
    Xb, yb = b
    r = Xb @ t - yb
    return 0.5 * (r ** 2).mean(), Xb.T @ r / Xb.shape[0]


def _two_leaf_problem():
    rng = np.random.default_rng(5)
    m, n, p = 5, 40, 3
    X = rng.standard_normal((m, n, p)).astype(np.float32)
    y = (X @ np.array([1.0, -2.0, 0.5]) + 0.7).astype(np.float32)

    def grad(t, b):
        Xb, yb = b
        r = Xb @ t["w"] + t["b"] - yb
        return 0.5 * (r ** 2).mean(), {"w": Xb.T @ r / n,
                                       "b": r.mean().reshape(1)}
    return X, y, grad


def _compare(out, tout, atol=ATOL, rtol=RTOL):
    for f in ("theta_cq", "theta_os", "theta_qn", "v_s", "v_y"):
        want = jax.tree_util.tree_leaves(getattr(out, f))
        got = transport.tree_leaves(getattr(tout, f))
        assert len(want) == len(got)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), _np(w), atol=atol,
                                       rtol=rtol, err_msg=f)
    for h in ("s_hist", "y_hist"):
        for w, g in zip(jax.tree_util.tree_leaves(getattr(out.mem, h)),
                        transport.tree_leaves(getattr(tout.mem, h))):
            np.testing.assert_allclose(g.numpy(), _np(w), atol=atol,
                                       rtol=rtol, err_msg=h)
    np.testing.assert_array_equal(tout.mem.count.numpy(),
                                  np.asarray(out.mem.count))
    np.testing.assert_allclose(tout.losses.numpy(), _np(out.losses),
                               atol=atol, rtol=rtol)
    np.testing.assert_allclose(float(tout.grad_norm), float(out.grad_norm),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("attack", ["scale", "gauss"])
def test_single_leaf_engine_matches_reference(attack, ref_knots):
    """The reference's single-leaf least squares (m = 5, n = 12, p = 4,
    hist 3, lr 0.4, eps 2), machine 0 attacked, on its draws; ``gauss``
    draws its corruption too (``attack_noise``)."""
    X, y = _least_squares(0, 5, 12, 4)
    kw = dict(hist=3, lr=0.4, eps=2.0)
    mask = np.arange(5) < 1
    key = jax.random.PRNGKey(42)
    theta0 = np.zeros(4, np.float32)
    out = jax.jit(lambda k, t: jrounds(
        k, t, (jnp.asarray(X), jnp.asarray(y)), _flat_grad,
        JTreeCfg(**kw), byz_mask=jnp.asarray(mask), attack=attack, n=12))(
        key, jnp.asarray(theta0))
    noise, att = reference_draws(key, jnp.asarray(theta0), 5)
    tout = protocol_tree_rounds(
        None, torch.from_numpy(theta0), (torch.from_numpy(X),
                                         torch.from_numpy(y)),
        _flat_grad, TreeProtocolConfig(**kw),
        byz_mask=torch.from_numpy(mask), attack=attack, n=12,
        noise=tree_draws_from_numpy(noise, "cpu"),
        attack_noise=tree_draws_from_numpy(att, "cpu"))
    _compare(out, tout)


def test_two_leaf_engine_matches_reference_over_three_steps(ref_knots):
    """The reference's two-leaf model (m = 5, n = 40, signflip on machine
    0, eps 50, hist 4), three steps threading the memory, on its draws."""
    X, y, grad = _two_leaf_problem()
    cfg = dict(hist=4, lr=0.5, eps=50.0)
    mask = np.arange(5) < 1
    step = jax.jit(lambda k, t, mm: jrounds(
        k, t, (jnp.asarray(X), jnp.asarray(y)), grad, JTreeCfg(**cfg),
        mem=mm, byz_mask=jnp.asarray(mask), attack="signflip", n=40))
    theta = {"w": jnp.zeros(3), "b": jnp.zeros(1)}
    mem = jbfgs.LBFGSMemory.init_like(4, theta, machines=5)
    ttheta = {"w": torch.zeros(3), "b": torch.zeros(1)}
    tmem = None
    key = jax.random.PRNGKey(6)
    for _ in range(3):
        key, sub = jax.random.split(key)
        out = step(sub, theta, mem)
        noise, _ = reference_draws(sub, theta, 5)
        tout = protocol_tree_rounds(
            None, ttheta, (torch.from_numpy(X), torch.from_numpy(y)), grad,
            TreeProtocolConfig(**cfg), mem=tmem,
            byz_mask=torch.from_numpy(mask), attack="signflip", n=40,
            noise=tree_draws_from_numpy(noise, "cpu"))
        _compare(out, tout)
        theta, mem = out.theta_qn, out.mem
        ttheta, tmem = tout.theta_qn, tout.mem
    assert int(tmem.count.max()) > 0


def test_flat_leaf_equals_single_leaf_tree_exactly():
    """``{'theta': flat}`` through the port's engine equals the flat
    tensor through it bit for bit, on a generator's draws."""
    X, y = _least_squares(0, 5, 12, 4)
    cfg = TreeProtocolConfig(hist=3, lr=0.4, eps=2.0)
    data = (torch.from_numpy(X), torch.from_numpy(y))
    mask = torch.arange(5) < 1
    grad = _flat_grad

    def grad_tree(t, b):
        loss, g = grad(t["theta"], b)
        return loss, {"theta": g}
    flat = protocol_tree_rounds(torch.Generator().manual_seed(3),
                                torch.zeros(4), data, grad, cfg,
                                byz_mask=mask, attack="gauss", n=12)
    tree = protocol_tree_rounds(torch.Generator().manual_seed(3),
                                {"theta": torch.zeros(4)}, data, grad_tree,
                                cfg, byz_mask=mask, attack="gauss", n=12)
    for f in ("theta_cq", "theta_os", "theta_qn", "v_s", "v_y"):
        assert torch.equal(getattr(flat, f), getattr(tree, f)["theta"]), f
    assert torch.equal(flat.losses, tree.losses)
    assert torch.equal(flat.mem.s_hist, tree.mem.s_hist["theta"])
    assert torch.equal(flat.mem.count, tree.mem.count)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wire_noise_draws_into_its_buffer(dtype):
    """On a generator at a number sigma, ``wire_noise`` noises the draw in
    its own buffer: bit for bit ``x + sigma * z`` with z the generator's
    next draw, flat and per leaf; a per-machine sigma broadcasts."""
    rng = np.random.default_rng(11)
    tree = {"a": _t(rng.standard_normal((4, 3, 5)), dtype),
            "b": _t(rng.standard_normal((4, 7)), dtype)}

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return [torch.randn(x.shape, generator=g, dtype=dtype)
                for x in transport.tree_leaves(tree)]
    got = transport.wire_noise(torch.Generator().manual_seed(1), tree, 0.3)
    for x, z, y in zip(transport.tree_leaves(tree), draws(1),
                       transport.tree_leaves(got)):
        assert y.dtype == dtype and torch.equal(y, x + 0.3 * z)
    flat = transport.wire_noise(torch.Generator().manual_seed(2),
                                tree["a"], 0.3)
    assert torch.equal(flat, tree["a"] + 0.3 * draws(2)[0])
    per = torch.tensor([0.0, 1.0, 2.0, 3.0])
    got = transport.wire_noise(torch.Generator().manual_seed(3), tree, per)
    for x, z, y in zip(transport.tree_leaves(tree), draws(3),
                       transport.tree_leaves(got)):
        s = per.to(dtype).reshape((4,) + (1,) * (x.dim() - 1))
        assert torch.equal(y, x + s * z)


def test_generator_draws_equal_the_same_draws_handed_in():
    """The engine on a generator equals the engine handed, as ``noise=``,
    the draws that generator gives: per transmission its noise slot of the
    sixteen-way split, leaf by leaf (the two-leaf model, signflip, eps 50,
    two steps threading the memory)."""
    from repro_torch.core import protocol
    X, y, grad = _two_leaf_problem()
    cfg = TreeProtocolConfig(hist=4, lr=0.5, eps=50.0)
    data = (torch.from_numpy(X), torch.from_numpy(y))
    kw = dict(byz_mask=torch.arange(5) < 1, attack="signflip", n=40)
    theta = {"w": torch.zeros(3), "b": torch.zeros(1)}
    mem_a = mem_b = None
    for seed in (4, 5):
        gens = protocol._split_key(torch.Generator().manual_seed(seed))
        noise = {name: {k: torch.randn((5,) + tuple(theta[k].shape),
                                       generator=gens[protocol._TREE_ROUNDS[
                                           name][1]]) for k in ("b", "w")}
                 for name in dp.TREE_TRANSMISSIONS}
        a = protocol_tree_rounds(torch.Generator().manual_seed(seed), theta,
                                 data, grad, cfg, mem=mem_a, **kw)
        b = protocol_tree_rounds(None, theta, data, grad, cfg, mem=mem_b,
                                 noise=noise, **kw)
        for f in ("theta_cq", "theta_os", "theta_qn", "v_s", "v_y"):
            for k in ("w", "b"):
                assert torch.equal(getattr(a, f)[k], getattr(b, f)[k]), f
        assert torch.equal(a.mem.count, b.mem.count)
        theta, mem_a, mem_b = a.theta_qn, a.mem, b.mem


def test_engine_trains_the_two_leaf_model():
    """25 port-native steps (a generator's draws) bring the loss under
    0.2 of the first: the reference test's own bar."""
    X, y, grad = _two_leaf_problem()
    cfg = TreeProtocolConfig(hist=4, lr=0.5, eps=50.0)
    theta = {"w": torch.zeros(3), "b": torch.zeros(1)}
    mem = bfgs.LBFGSMemory.init_like(4, theta, machines=5)
    gen = torch.Generator().manual_seed(6)
    losses = []
    for _ in range(25):
        out = protocol_tree_rounds(
            gen, theta, (torch.from_numpy(X), torch.from_numpy(y)), grad,
            cfg, mem=mem, byz_mask=torch.arange(5) < 1, attack="signflip",
            n=40)
        theta, mem = out.theta_qn, out.mem
        losses.append(float(out.losses.mean()))
    assert losses[-1] < 0.2 * losses[0]
    assert int(mem.count.max()) > 0


def test_first_step_with_identical_rows_matches_reference():
    """The first step, noiseless, every machine on the same data: the
    memory is empty, so R3's rows are all g_cq and dcq_mad's MAD is 0
    (guarded by MAD_EPS); the port agrees with the reference there."""
    X, y = _least_squares(2, 1, 12, 4)
    X, y = np.repeat(X, 4, 0), np.repeat(y, 4, 0)
    cfg = dict(hist=2, lr=0.5)
    out = jax.jit(lambda t: jrounds(
        jax.random.PRNGKey(0), t, (jnp.asarray(X), jnp.asarray(y)),
        _flat_grad, JTreeCfg(**cfg)))(jnp.zeros(4))
    tout = protocol_tree_rounds(None, torch.zeros(4),
                                (torch.from_numpy(X), torch.from_numpy(y)),
                                _flat_grad, TreeProtocolConfig(**cfg))
    _compare(out, tout)
    np.testing.assert_array_equal(tout.mem.count.numpy(), [1, 1, 1, 1])


def test_engine_refusals_and_in_place_memory():
    X, y = _least_squares(0, 5, 12, 4)
    data = (torch.from_numpy(X), torch.from_numpy(y))
    grad = _flat_grad
    with pytest.raises(ValueError, match="needs n"):
        protocol_tree_rounds(torch.Generator(), torch.zeros(4), data, grad,
                             TreeProtocolConfig(eps=1.0))
    with pytest.raises(ValueError, match="generator"):
        protocol_tree_rounds(None, torch.zeros(4), data, grad,
                             TreeProtocolConfig(eps=1.0), n=12)
    with pytest.raises(ValueError, match="generator"):
        protocol_tree_rounds(None, torch.zeros(4), data, grad,
                             TreeProtocolConfig(), attack="gauss",
                             byz_mask=torch.arange(5) < 1)
    mem = bfgs.LBFGSMemory.init_like(2, torch.zeros(4), machines=5)
    out = protocol_tree_rounds(None, torch.zeros(4), data, grad,
                               TreeProtocolConfig(hist=2), mem=mem)
    assert out.mem is mem and mem.count.tolist() == [1] * 5


def test_bf16_tree_keeps_the_leaf_dtype():
    """A bf16 tree: the port keeps every tree in bf16, where the
    reference's f32 gamma promotes theta_os, theta_qn and the pair to f32
    (ROADMAP C); the first step's theta_qn agrees within bf16 rounding."""
    X, y, grad = _two_leaf_problem()
    theta = {"w": jnp.zeros(3, jnp.bfloat16), "b": jnp.zeros(1, jnp.bfloat16)}

    def jgrad(t, b):
        loss, g = grad(jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32), t), b)
        return loss, jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                            g)

    def tgrad(t, b):
        loss, g = grad(transport.tree_map(lambda x: x.float(), t), b)
        return loss, transport.tree_map(lambda x: x.to(torch.bfloat16), g)
    cfg = dict(hist=2, lr=0.5)
    out = jax.jit(lambda t: jrounds(
        jax.random.PRNGKey(0), t, (jnp.asarray(X), jnp.asarray(y)), jgrad,
        JTreeCfg(**cfg)))(theta)
    tout = protocol_tree_rounds(
        None, {"w": torch.zeros(3, dtype=torch.bfloat16),
               "b": torch.zeros(1, dtype=torch.bfloat16)},
        (torch.from_numpy(X), torch.from_numpy(y)), tgrad,
        TreeProtocolConfig(**cfg))
    assert out.theta_qn["w"].dtype == jnp.float32
    for f in ("theta_cq", "theta_os", "theta_qn", "v_s", "v_y"):
        for g in transport.tree_leaves(getattr(tout, f)):
            assert g.dtype == torch.bfloat16, f
    for w, g in zip(jax.tree_util.tree_leaves(out.theta_qn),
                    transport.tree_leaves(tout.theta_qn)):
        np.testing.assert_allclose(g.float().numpy(), _np(w), rtol=2 ** -6,
                                   atol=2 ** -6 * float(np.abs(_np(w)).max()))


def test_each_round_frees_its_buffers(monkeypatch):
    """No ``(m, *leaf)`` buffer outlives its round: when a round allocates
    its buffers, the ones of the round before are gone (a view held past
    its round keeps the whole buffer alive; at full width a round's
    buffers are 4 parameter copies)."""
    import weakref

    from repro_torch.core import protocol
    made = []
    real = protocol._stacks

    def tracked(leaves, m):
        for rnd in made:
            assert all(r() is None for r in rnd), \
                f"round {len(made) - 1}'s buffers are still alive"
        out = real(leaves, m)
        made.append([weakref.ref(b) for b in out])
        return out
    monkeypatch.setattr(protocol, "_stacks", tracked)
    X, y, grad = _two_leaf_problem()
    for local_steps in (1, 2):
        made.clear()
        out = protocol_tree_rounds(
            torch.Generator().manual_seed(0),
            {"w": torch.zeros(3), "b": torch.zeros(1)},
            (torch.from_numpy(X), torch.from_numpy(y)), grad,
            TreeProtocolConfig(hist=2, eps=50.0, local_steps=local_steps),
            byz_mask=torch.arange(5) < 1, attack="signflip", n=40)
        assert len(made) == 5
        assert all(r() is None for rnd in made for r in rnd)
        del out
