"""The port's multi-device layer across ranks on the CPU: gloo groups of
1 to 4 processes against the reference's SPMD paths and against the
port's own single-process paths.

* Port side: ``torch.multiprocessing`` spawns one gloo group per world
  size (tests/torch_dist_workers.py, one thread a rank, a ``FileStore``
  under ``tmp_path``), every world running all of its cases at once.
* Reference side: one subprocess with forced host devices (as
  tests/test_dist.py runs it) running ``run_sharded``,
  ``sharded_aggregate_leaf`` and ``run_sharded_tree`` under
  ``AxisType.Auto`` meshes. Both sides start together.
* The launchers: ``torchrun --standalone`` (a free port of its own) with
  two CPU ranks, against one rank in this process.
* The service across ranks: worlds 1 and 2 serve the parent's updates
  with the reference's noise draws (``flush(noise=)``), against the
  port's unsharded service and the reference's ``AggregationService``
  (run here, on the same updates and draws).

Inputs are numpy draws from a seed; the reference's noise (its 16-way key
split, as tests/test_torch_protocol.py and tests/test_torch_qn.py rebuild
it) and its float32 DCQ knots are handed to the port. Tolerances: the
flat protocol 1e-5 (atol and rtol, the reference's own for its sharded
path), ``sharded_aggregate_leaf`` 1e-4 (tests/test_dist.py's), the tree
engine tests/test_torch_qn.py's 1e-5, the service
tests/test_torch_serve.py's 2e-5; the port's sharded paths equal its
unsharded ones and one rank's launchers bit for bit.
"""
import contextlib
import io
import json
import os
import pickle
import re
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from repro.agg import reference as jagg_ref
from repro.core import transport as jtransport
from repro.core.keys import stream_key
import torch_dist_workers as W

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
N, P = 200, 4
#: the reference's transmission key slots (core/protocol.py)
KEY_INDEX = {"R1 theta": 0, "R2 grad": 2, "R3 newton-dir": 6,
             "R4 grad-diff": 8, "R5 bfgs-dir": 10}
TREE_SLOTS = {"R1 theta": 0, "R2 grad": 2, "R3 newton-dir": 6,
              "R4 grad-diff": 8, "R5 bfgs-dir": 10}
REFERENCE_WORLD = {9: 3, 8: 4}

REFERENCE = """
import os, pickle, sys
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec as P
from repro.configs.base import ProtocolConfig, TreeProtocolConfig
from repro.core import get_problem
from repro.core.bfgs import LBFGSMemory
from repro.dist.collectives import sharded_aggregate_leaf
from repro.dist.grad_agg import GradAggConfig
from repro.dist.sharded_protocol import run_sharded, run_sharded_tree
import torch_dist_workers as W

inp = pickle.load(open({inputs!r}, 'rb'))
def mesh(w):
    return jax.make_mesh((w,), ('machines',), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:w])
out = {{'flat': {{}}}}
for name, (rows, noiseless, attack, factor, byz) in W.FLAT_CASES.items():
    X, y = inp['data'][rows]
    mask = jnp.arange(rows - 1) < 1 if byz else None
    res = run_sharded(get_problem('logistic'),
                      ProtocolConfig(eps=30.0, delta=0.05,
                                     noiseless=noiseless),
                      mesh({world}[rows]), jnp.asarray(inp['keys'][name]),
                      jnp.asarray(X), jnp.asarray(y), byz_mask=mask,
                      attack=attack, attack_factor=factor)
    out['flat'][name] = {{f: np.asarray(res[f])
                         for f in ('theta_cq', 'theta_os', 'theta_qn')}}
m4 = mesh(4)
g = jax.device_put(jnp.asarray(inp['leaf']), NamedSharding(m4, P('machines')))
with jax.sharding.use_mesh(m4):
    out['leaf'] = np.asarray(jax.jit(lambda x: sharded_aggregate_leaf(
        x, GradAggConfig(method='dcq'), m4, P('machines')))(g))
X, y = (jnp.asarray(a) for a in inp['tree_data'])
theta = {{'w': jnp.zeros(3), 'b': jnp.zeros(1)}}
mem = LBFGSMemory.init_like(W.TREE_CFG['hist'], theta, machines=W.TREE_M)
steps = []
for k in inp['tree_keys']:
    o = run_sharded_tree(jnp.asarray(k), theta, (X, y), W.two_leaf_grad,
                         TreeProtocolConfig(**W.TREE_CFG),
                         mesh(W.TREE_WORLD), mem=mem,
                         byz_mask=jnp.arange(W.TREE_M) < 1,
                         attack='signflip', n=W.TREE_N)
    steps.append(jax.tree_util.tree_map(np.asarray, o._asdict()))
    theta, mem = o.theta_qn, o.mem
out['tree'] = steps
pickle.dump(out, open({result!r}, 'wb'))
"""


def _flat_data(rows, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((rows, N, P)).astype(np.float32)
    z = X @ np.full(P, 0.5 / np.sqrt(P), np.float32)
    y = (rng.random((rows, N)) < 1.0 / (1.0 + np.exp(-z)))
    return X, y.astype(np.float32)


def _flat_noise(key, rows):
    keys = jax.random.split(key, 16)
    return {name: np.asarray(jax.random.normal(keys[i], (rows, P),
                                               jnp.float32))
            for name, i in KEY_INDEX.items()}


def _tree_noise(key, m):
    """The reference tree engine's noise for ``key`` on the two-leaf
    theta: ``{transmission: {"b": (m, 1), "w": (m, 3)}}``."""
    keys = jax.random.split(key, 16)
    shapes = (("b", (1,)), ("w", (3,)))       # its leaf order
    out = {}
    for name, slot in TREE_SLOTS.items():
        ks = jtransport._leaf_keys(keys[slot], len(shapes))
        out[name] = {leaf: np.asarray(jax.random.normal(
            kk, (m,) + shape, jnp.float32))
            for kk, (leaf, shape) in zip(ks, shapes)}
    return out


def _serve_inputs():
    """The service's theta, every round's arrivals (numpy trees) and the
    reference service's own noise of each round (its ``fold_in`` of the
    ``serve`` stream, one key a leaf)."""
    rng = np.random.default_rng(40)
    theta = {"w": np.zeros((3, 2), np.float32), "b": np.zeros(3, np.float32)}
    jtheta = jax.tree_util.tree_map(jnp.asarray, theta)
    leaves = jax.tree_util.tree_leaves(jtheta)
    updates, noise = [], []
    for r, n in enumerate(W.SERVE_ARRIVALS):
        updates.append({k: rng.standard_normal((n,) + v.shape)
                        .astype(np.float32) for k, v in theta.items()})
        key = jax.random.fold_in(stream_key(W.SERVE_CFG["seed"], "serve"), r)
        noise.append([np.asarray(jax.random.normal(
            k, (W.SERVE_C,) + x.shape, x.dtype))
            for k, x in zip(jtransport._leaf_keys(key, len(leaves)),
                            leaves)])
    return {"theta": theta, "updates": updates, "noise": noise}


def _inputs():
    data = {rows: _flat_data(rows, rows) for rows in (9, 8)}
    keys, noise = {}, {}
    for i, (name, case) in enumerate(W.FLAT_CASES.items()):
        key = jax.random.PRNGKey(100 + i)
        keys[name] = np.asarray(key)
        if not case[1]:
            noise[name] = _flat_noise(key, case[0])
    rng = np.random.default_rng(5)
    tx = rng.standard_normal((W.TREE_M, W.TREE_N, 3)).astype(np.float32)
    ty = (tx @ np.array([1.0, -2.0, 0.5]) + 0.7).astype(np.float32)
    key, tree_keys = jax.random.PRNGKey(6), []
    for _ in range(W.TREE_STEPS):
        key, sub = jax.random.split(key)
        tree_keys.append(np.asarray(sub))
    return {"data": data, "keys": keys, "noise": noise,
            "knots": np.asarray(jagg_ref.quantile_knots(10)),
            "leaf": np.random.default_rng(0).standard_normal(
                (8, 13, 7)).astype(np.float32),
            "tree_data": (tx, ty), "tree_keys": tree_keys,
            "tree_noise": [_tree_noise(jnp.asarray(k), W.TREE_M)
                           for k in tree_keys],
            "serve": _serve_inputs()}


#: the launchers' runs on two ranks: name -> (module, argv)
TRAIN_ARGS = ["--config", "glm4-9b", "--steps", "2", "--seq", "16",
              "--machines", "4", "--byzantine", "0.25", "--device", "cpu"]
LAUNCHES = {
    "sweep": ["repro_torch.sweep", "--preset", "smoke", "--fast",
              "--device", "cpu", "--out", "art.json"],
    "adamw": ["repro_torch.launch.train", *TRAIN_ARGS, "--optimizer",
              "adamw", "--agg", "dcq", "--attack", "scale", "--eps", "1",
              "--ckpt", "ck.npz"],
    "qn": ["repro_torch.launch.train", *TRAIN_ARGS, "--optimizer", "qn",
           "--agg", "median", "--attack", "signflip", "--ckpt", "ck.npz"],
    "serve": ["repro_torch.launch.serve", "--config", "glm4-9b",
              "--machines", "8", "--rounds", "3", "--agg", "dcq_mad",
              "--eps", "1", "--byzantine", "0.25", "--attack", "signflip",
              "--dropout", "0.25", "--ingest-block", "4", "--device", "cpu"],
}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Every process of this module, started at once: the reference
    subprocess, the port's four worlds (1 + 2 + 3 + 4 ranks) and the
    launchers on two ranks under ``torchrun --standalone`` (one thread a
    rank). Yields ``(base directory, jobs)``."""
    base = tmp_path_factory.mktemp("ranks")
    inputs, result = str(base / "inputs.pkl"), str(base / "reference.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(_inputs(), f)
    code = textwrap.dedent(REFERENCE).format(
        src=SRC, tests=os.path.dirname(os.path.abspath(__file__)),
        inputs=inputs, result=result, world=REFERENCE_WORLD)
    jobs = {"reference": subprocess.Popen(
        [sys.executable, "-c", code], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    for name, argv in LAUNCHES.items():
        (base / name).mkdir()
        jobs[name] = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "2", "-m", *argv, "--sharded"],
            cwd=base / name, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    for world in (1, 2, 3, 4):
        out = base / f"world{world}"
        out.mkdir()
        jobs[world] = tmp.start_processes(
            W.run_world, args=(world, str(base / f"store{world}"), inputs,
                               str(out)),
            nprocs=world, join=False, start_method="spawn")
    yield base, jobs
    for job in jobs.values():
        if isinstance(job, subprocess.Popen) and job.poll() is None:
            job.kill()


def _finish(job) -> str:
    out, err = job.communicate(timeout=600)
    assert job.returncode == 0, err[-3000:]
    return out


@pytest.fixture(scope="module")
def runs(started):
    """(reference results, {world: [every rank's results]})."""
    base, jobs = started
    ports = {}
    deadline = time.monotonic() + 600
    for world in (1, 2, 3, 4):
        while not jobs[world].join(timeout=1):
            assert time.monotonic() < deadline, f"world {world} hangs"
        ports[world] = []
        for r in range(world):
            with open(base / f"world{world}" / f"rank{r}.pkl", "rb") as f:
                ports[world].append(pickle.load(f))
    _finish(jobs["reference"])
    with open(base / "reference.pkl", "rb") as f:
        return pickle.load(f), ports


THETAS = ("theta_cq", "theta_os", "theta_qn")
FLAT = [(world, name) for name, case in W.FLAT_CASES.items()
        for world in W.PORT_WORLDS[case[0]]]


@pytest.mark.parametrize("world,case", FLAT,
                         ids=[f"world{w}-{c}" for w, c in FLAT])
def test_run_sharded_matches_reference(runs, world, case):
    """``run_sharded`` on ``world`` gloo ranks against the reference's
    ``run_sharded`` on an ``AxisType.Auto`` mesh (world 3 for m + 1 = 9,
    world 4 for 8) within 1e-5; every rank holds the same estimators. They
    equal the port's unsharded ``DPQNProtocol.run`` bit for bit at world
    1 and within 1e-5 elsewhere: a rank's batch of machines is smaller,
    and the CPU's batched products then may sum in another order (a few
    ulp)."""
    ref, ports = runs
    rank0 = ports[world][0]["flat"][case]
    for f in THETAS:
        np.testing.assert_allclose(rank0[f], ref["flat"][case][f],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
        if world == 1:
            np.testing.assert_array_equal(rank0[f], rank0["unsharded"][f],
                                          err_msg=f)
        else:
            np.testing.assert_allclose(rank0[f], rank0["unsharded"][f],
                                       atol=1e-5, rtol=1e-5, err_msg=f)
        for other in ports[world][1:]:
            np.testing.assert_array_equal(other["flat"][case][f], rank0[f])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_aggregate_leaf_matches_reference(runs, world):
    """dcq over an (8, 13, 7) leaf whose rows are spread over the ranks,
    against the reference's shard_map collective at world 4, within 1e-4;
    the same aggregate on every rank."""
    ref, ports = runs
    for rank in ports[world]:
        assert rank["leaf"].shape == (13, 7)
        np.testing.assert_allclose(rank["leaf"], ref["leaf"], atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(rank["leaf"], ports[world][0]["leaf"])


def test_sharded_tree_engine_matches_reference_and_unsharded(runs):
    """``run_sharded_tree`` at world 2 (m = 4, two machines a rank, two
    steps threading the memory, signflip on machine 0, the reference's
    draws) against the reference's ``run_sharded_tree`` at
    tests/test_torch_qn.py's 1e-5, and against the port's unsharded
    engine bit for bit. Each rank keeps its own two machines' memory."""
    ref, ports = runs
    ranks = ports[W.TREE_WORLD]
    for step, want in enumerate(ref["tree"]):
        got = ranks[0]["tree"]["sharded"][step]
        one = ranks[0]["tree"]["unsharded"][step]
        for f in ("theta_cq", "theta_os", "theta_qn", "v_s", "v_y"):
            leaves = jax.tree_util.tree_leaves(want[f])
            for g, w, u in zip(got[f], leaves, one[f]):
                np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5,
                                           err_msg=f)
                np.testing.assert_array_equal(g, u, err_msg=f)
        for f in ("losses", "grad_norm"):
            np.testing.assert_allclose(got[f][0], want[f], atol=1e-5,
                                       rtol=1e-5)
            np.testing.assert_array_equal(got[f][0], one[f][0])
        for h in ("s_hist", "y_hist"):
            for leaf, w in getattr(want["mem"], h).items():
                np.testing.assert_allclose(got["mem"][h][leaf], w,
                                           atol=1e-5, rtol=1e-5, err_msg=h)
                np.testing.assert_array_equal(got["mem"][h][leaf],
                                              one["mem"][h][leaf])
        np.testing.assert_array_equal(got["count"], want["mem"].count)
        assert got["local_machines"] == W.TREE_M // W.TREE_WORLD
        for other in ranks[1:]:
            np.testing.assert_array_equal(
                other["tree"]["sharded"][step]["theta_qn"][1],
                got["theta_qn"][1])
    assert int(ranks[0]["tree"]["sharded"][-1]["count"].max()) > 0


def test_uneven_machines_are_refused(runs):
    """8 machine rows on 3 ranks, and a tree of 4 machines on 3, raise the
    reference's "do not shard evenly"."""
    msgs = runs[1][3][0]["refusals"]
    assert len(msgs) == 2
    assert "8 machines do not shard evenly over 3 devices" in msgs[0]
    assert "4 machines do not shard evenly over 3 devices" in msgs[1]


# ------------------------------------------------------------- launchers

@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_torchrun_sweep_equals_one_rank(started, tmp_path, one_thread):
    """``--preset smoke --fast --sharded`` on two CPU ranks (m + 1 = 8
    rows, four a rank): the artifact equals one rank's scenario for
    scenario (records exactly but for thetas and metrics, which are held
    at 1e-5 relative: the ranks' smaller batches may sum in another
    order), and its ``n_devices`` is the world size."""
    from repro_torch.sweep import cli as tcli
    base, jobs = started
    one = str(tmp_path / "one.json")
    assert tcli.main(LAUNCHES["sweep"][1:-1] + [one]) == 0
    out = _finish(jobs["sweep"])
    assert out.count("wrote art.json") == 1            # rank 0 alone
    with open(one) as f:
        a = json.load(f)
    with open(base / "sweep" / "art.json") as f:
        b = json.load(f)
    assert (a["meta"]["n_devices"], b["meta"]["n_devices"]) == (1, 2)
    assert a["scenarios"].keys() == b["scenarios"].keys()
    for sid, rec in a["scenarios"].items():
        got = b["scenarios"][sid]
        for k in ("scenario", "spend", "comm"):
            assert got[k] == rec[k], (sid, k)
        want = np.asarray(rec["thetas_qn"])
        np.testing.assert_allclose(got["thetas_qn"], want, atol=0,
                                   rtol=1e-5 * (1 + np.abs(want).max()))
        assert got["metrics"].keys() == rec["metrics"].keys()
        for k, v in rec["metrics"].items():
            assert got["metrics"][k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.parametrize("optimizer", ["adamw", "qn"])
def test_torchrun_train_equals_one_rank(started, tmp_path, one_thread,
                                        optimizer):
    """The train launcher at ``--machines 4`` on two CPU ranks (two
    machines a rank; AdamW on dcq under scale with eps 1, or the QN step
    on the median under signflip): the same losses as one rank, and the
    same checkpoint, the QN memory gathered from both ranks, bit for bit
    (each rank computes its machines one by one, as one rank does)."""
    from repro_torch.launch import train as launcher
    base, jobs = started
    argv = LAUNCHES[optimizer][1:-1] + [str(tmp_path / "ck.npz")]
    losses = launcher.main(argv)
    out = _finish(jobs[optimizer])
    assert out.count("[train] done") == 1              # rank 0 alone
    assert f"first loss {losses[0]:.4f} -> last {losses[-1]:.4f}" in out
    assert "2 rank(s)" in out
    with np.load(tmp_path / "ck.npz") as a, \
            np.load(base / optimizer / "ck.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------- the service across ranks

@pytest.fixture(scope="module")
def serve_reference():
    """The reference's ``AggregationService`` on the same updates: every
    round's aggregate and theta, and its ledger."""
    from repro.serve import (AggregationService, FlushPolicy,
                             ServeConfig)
    inp = _serve_inputs()
    svc = AggregationService(
        jax.tree_util.tree_map(jnp.asarray, inp["theta"]),
        ServeConfig(**W.SERVE_CFG), policy=FlushPolicy(**W.SERVE_POLICY))
    rounds = []
    for ups in inp["updates"]:
        svc.submit_many(jax.tree_util.tree_map(jnp.asarray, ups))
        red = svc.flush()
        rounds.append({f: [np.asarray(x) for x in
                           jax.tree_util.tree_leaves(t)]
                       for f, t in (("agg", red), ("theta", svc.theta))})
    return {"rounds": rounds, "ledger": svc.ledger,
            "fills": [h["fill"] for h in svc.history]}


@pytest.mark.parametrize("world", W.SERVE_WORLDS)
def test_sharded_service_matches_unsharded_and_reference(
        runs, serve_reference, world):
    """The ring buffer over ``world`` gloo ranks (capacity 6; a full ring,
    a wrap past capacity, a partial fill of 5; eps 0.5, dcq_mad): every
    rank holds its capacity / world rows and serves the same rounds, equal
    to the port's unsharded service bit for bit (the gather rebuilds the
    unsharded buffer) and to the reference's service within 2e-5, with
    the same fills and ledger."""
    ranks = runs[1][world]
    one = ranks[0]["serve"]["unsharded"]
    want = serve_reference
    for rank in ranks:
        got = rank["serve"]["sharded"]
        assert got["rows"] == W.SERVE_C // world
        assert got["fills"] == one["fills"] == want["fills"] == [6, 6, 5]
        assert got["ledger"] == one["ledger"] == want["ledger"]
        for r, (a, b, w) in enumerate(zip(got["rounds"], one["rounds"],
                                          want["rounds"])):
            for f in ("agg", "theta"):
                for x, y, z in zip(a[f], b[f], w[f]):
                    np.testing.assert_array_equal(x, y, err_msg=f"{r} {f}")
                    np.testing.assert_allclose(x, z, atol=2e-5, rtol=2e-5,
                                               err_msg=f"{r} {f}")


def test_sharded_service_refusals(runs):
    """Capacity 5 on two ranks raises the uneven-sharding error; ranks
    handed different arrivals (fills 3 and 4) both refuse to flush."""
    for rank in runs[1][2]:
        uneven, fills = rank["serve_refusals"]
        assert "capacity 5 does not shard evenly over 2 devices" in uneven
        assert "divisible by 2" in uneven
        assert "different fills (from 3 to 4)" in fills


def _untimed(text: str) -> list:
    """The launcher's printed lines with their clock readings masked."""
    text = re.sub(r"latency +[0-9.]+ ms", "latency <ms>", text)
    text = re.sub(r"in [0-9.]+s; steady flush [0-9.]+ ms",
                  "in <s>; steady flush <ms>", text)
    return text.splitlines()


def test_torchrun_serve_equals_one_rank(started, one_thread):
    """``launch.serve --sharded`` on two CPU ranks (8 machines, 4 a rank;
    every round a partial fill of 6, so rank 1 holds 2 of its 4 slots;
    eps 1, signflip) prints what one rank prints, clock readings aside:
    the same rounds and fills, launches and privacy spend, and the
    sharding line once (rank 0 alone prints). The served theta across
    ranks is held by test_sharded_service_matches_unsharded_and_reference."""
    from repro_torch.launch import serve as launcher
    base, jobs = started
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        svc = launcher.main(LAUNCHES["serve"][1:])
    out = _untimed(_finish(jobs["serve"]))
    assert out.count("[serve] ring buffer sharded over 2 device(s)") == 1
    assert [h["fill"] for h in svc.history] == [6, 6, 6]
    one = _untimed(log.getvalue())
    assert sum("fill     6/8" in line for line in one) == 3
    assert [line for line in out if "sharded over" not in line] == one
