"""The sweep executor — ``repro/sweep/executor.py`` counterpart.

Scenarios are bucketed by ``Scenario.group_key()`` (static config +
shapes), and the groups run in order. Each scenario is ONE
``protocol_rounds(..., reps=s.reps)`` call on the executor's device: its
replicates ride the protocol's replicate axis, so every center-side
aggregation of the scenario is one launch of the order-statistics kernel
on a CUDA device. (The reference pushes a whole group through one
compiled ``vmap`` over scenarios; a scenario axis in ``protocol_rounds``
is later work, ROADMAP.)

Oversized groups are CHUNKED: with ``chunk_size=c`` a group larger than
``c`` runs as ceil(len/c) chunks, and the artifact is written atomically
after every chunk, so an interrupted group resumes from its completed
chunks. The reference pads the last chunk to ``c`` rows to keep one
executable; with one call per scenario there is no batch shape to keep,
so the port runs the real scenarios only and records the same results.

Training scenarios (``TrainScenario``, the ``zoo-smoke`` preset) run
group by group too: one model of the group's reduced config (remat on)
and one engine config, then per scenario ``steps`` calls of
``protocol_tree_rounds`` from its own parameters and an empty L-BFGS
memory, eps handed over as per-leaf sigma trees. The reference pins its
zoo draws to ``PRNGKey(seed)``, ``PRNGKey(1000 + seed)`` and
``PRNGKey(seed + 1)``; the port draws the parameters, the engine's draws
and the batches from the ``params``, ``protocol`` and ``batches`` streams
of ``seed`` (``core.keys``), so losses differ while the spend ledger and
the ``comm`` record, which depend only on the tree's leaf sizes, equal
the reference's.

``mesh`` (a 1-D machine mesh over ``torch.distributed`` ranks,
``launch.cli.machine_mesh``) spreads every scenario's machines over the
ranks, each rank running the executor alike: flat groups go through the
protocol's machine map (m + 1 must divide over the ranks), training groups
through the sharded tree engine (m must), the center's work and the
records are the same on every rank, and only rank 0 writes the artifact.
``meta["n_devices"]`` is the world size.

``inputs`` (optional) replaces the executor's own data and draws: a
callable ``scenario -> (X, y, aux, noise, attack_noise)``, the opening
``protocol_rounds(noise=, attack_noise=)`` gives (tables keyed by
transmission name with a leading replicate axis; two Nones draw from the
executor's replicate generators). A parity test feeds the reference's
data and draws through it; nothing on the main path uses it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import privacy, resolve_device
from repro_torch.agg import kernel
from repro_torch.configs import get_config
from repro_torch.core import dp
from repro_torch.core.bfgs import LBFGSMemory
from repro_torch.core.keys import stream_generator
from repro_torch.core.losses import get_problem
from repro_torch.core.protocol import (ALL_MACHINES, _failure_probs,
                                       n_transmissions, protocol_rounds,
                                       protocol_tree_rounds)
from repro_torch.core.transport import tree_map, tree_size
from repro_torch.data.lm import make_batch
from repro_torch.models.model import Model
from repro_torch.sweep import artifact as artifact_mod
from repro_torch.sweep.comm import comm_record
from repro_torch.sweep.data import (build_data, byz_mask, compute_metrics,
                                    replicate_draws)
from repro_torch.sweep.grid import (Scenario, TrainScenario, group_label,
                                    group_scenarios)
from repro_torch.train.trainer import make_grad_fn, split_machines

Inputs = Callable[[Scenario], Tuple]


class SweepExecutor:
    """Runs scenario lists group by group on one device (``cuda`` unless
    ``device`` says otherwise). ``launches[scenario_id]`` counts the
    order-statistics kernel launches of each scenario's run (0 on the
    CPU, where the aggregations take their plain PyTorch path)."""

    def __init__(self, device=None,
                 progress: Optional[Callable[[str], None]] = None,
                 chunk_size: Optional[int] = None,
                 inputs: Optional[Inputs] = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is None:
            self.machine_map = ALL_MACHINES
        else:
            from repro_torch.dist.sharded_protocol import machine_map
            self.machine_map = machine_map(mesh)
        self.progress = progress or (lambda msg: None)
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.chunk_size = chunk_size
        self.inputs = inputs
        self.launches: Dict[str, int] = {}
        self._data_cache: Dict[Tuple, Tuple] = {}

    # --------------------------------------------------------------- inputs

    def _data_for(self, s: Scenario):
        """build_data memoized on the fields that determine the tensors —
        a fig-eps group's five budgets share one dataset."""
        key = (s.dataset, s.problem, s.m, s.n, s.p, s.data_seed, s.pair)
        if key not in self._data_cache:
            self._data_cache[key] = build_data(s, self.device)
        return self._data_cache[key]

    def _inputs_for(self, s: Scenario):
        """(X, y, aux, noise, attack_noise) on the executor's device."""
        if self.inputs is None:
            return self._data_for(s) + replicate_draws(s, self.device)
        X, y, aux, noise, attack_noise = self.inputs(s)
        dev = self.device
        if noise is None and attack_noise is None:
            noise, attack_noise = replicate_draws(s, dev)

        def mv(t):
            return None if t is None else torch.as_tensor(t, device=dev)

        def mv_table(table):
            return None if table is None else \
                {k: mv(t) for k, t in table.items()}
        return (mv(X), mv(y), {k: mv(t) for k, t in aux.items()},
                mv_table(noise), mv_table(attack_noise))

    def _run_one(self, s: Scenario):
        """One scenario: one ``protocol_rounds`` call over its replicates.
        Returns the protocol's arrays, the metric aux and the kernel
        launches the call made."""
        X, y, aux, noise, attack_noise = self._inputs_for(s)
        before = kernel.launches
        arrs = protocol_rounds(
            X, y, get_problem(s.problem), s.protocol_config(),
            byz_mask=byz_mask(s, self.device), attack=s.attack,
            attack_factor=s.attack_factor, reps=s.reps, noise=noise,
            attack_noise=attack_noise, machine_map=self.machine_map)
        return arrs, aux, kernel.launches - before

    # ------------------------------------------------------------ training

    @staticmethod
    def _train_engine(scenario: TrainScenario):
        """The group's per-machine ``grad_fn`` (the forward pass of its
        reduced config with remat on, taking the parameters it is given),
        the config and the engine config. (The reference compiles and
        caches one step per group; here there is nothing to compile.)"""
        cfg = get_config(scenario.arch, reduced=True)
        model = Model(cfg, device="meta", remat=True)
        return make_grad_fn(model), cfg, scenario.protocol_config()

    def _run_train_group(self, scens: List[TrainScenario],
                         label: str) -> List[Dict]:
        """Run one zoo group scenario by scenario; returns one artifact
        record per scenario."""
        grad_fn, cfg, tcfg = self._train_engine(scens[0])
        dev = self.device
        records = []
        for s in scens:
            m = s.machines
            t0 = time.perf_counter()
            before = kernel.launches
            params = tree_map(torch.Tensor.detach, Model(
                cfg, device=dev, generator=stream_generator(
                    s.seed, "params", device=dev)).params())
            mem = LBFGSMemory.init_like(
                s.hist, params, machines=m // self.machine_map.world)
            mask = torch.arange(m, device=dev) < s.n_byzantine()
            if s.eps > 0:
                sigmas = dp.calibrate_tree_sigmas(
                    params, s.n_per_machine(), s.eps, s.delta,
                    (s.gamma,) * 5, s.tail, accountant=s.accountant)
            else:
                sigmas = {name: 0.0 for name in dp.TREE_TRANSMISSIONS}
            key = stream_generator(s.seed, "protocol", device=dev)
            data = stream_generator(s.seed, "batches", device=dev)
            losses, gnorm = [], 0.0
            for _ in range(s.steps):
                mb = split_machines(make_batch(data, cfg, s.batch, s.seq), m)
                out = protocol_tree_rounds(
                    key, params, mb, grad_fn, tcfg, mem=mem, byz_mask=mask,
                    attack=s.attack, attack_factor=s.attack_factor,
                    sigmas=sigmas, machine_map=self.machine_map)
                params, mem = out.theta_qn, out.mem
                losses.append(float(out.losses.mean()))
                gnorm = float(out.grad_norm)
            dt = time.perf_counter() - t0
            launches = kernel.launches - before
            self.launches[s.scenario_id()] = launches
            p_total = tree_size(params)
            k = len(dp.TREE_TRANSMISSIONS)
            records.append({
                "scenario": s.to_json(),
                "metrics": {"loss_first": losses[0],
                            "loss_last": losses[-1],
                            "loss_drop": losses[0] - losses[-1],
                            "losses": losses,
                            "grad_norm_last": gnorm},
                "spend": _train_spend_record(s, params),
                "comm": {"n_transmissions": k,
                         "bytes_per_round": 4 * p_total,
                         "bytes_per_machine": 4 * p_total * k,
                         "n_params": p_total,
                         "eps_per_round": s.eps / k,
                         "delta_per_round": s.delta / k},
                "thetas_qn": None,
                "timing": {"group": label, "group_seconds": dt,
                           "group_size": len(scens), "steps": s.steps,
                           "launches": launches},
            })
        return records

    # ------------------------------------------------------------------ run

    def run(self, scenarios: Iterable[Scenario],
            artifact_path: Optional[str] = None, resume: bool = True,
            store_thetas: bool = True, meta: Optional[Dict] = None) -> Dict:
        """Execute scenarios group-by-group; returns the artifact dict.

        With ``artifact_path`` the artifact is written atomically after
        every chunk, and (when ``resume``) scenarios already present in a
        schema-valid artifact at that path are skipped.
        """
        scenarios = list(scenarios)
        art = artifact_mod.new_artifact(meta=self._meta(meta))
        done: set = set()
        if artifact_path and resume:
            done = artifact_mod.load_done_ids(artifact_path)
            if done:
                art = artifact_mod.load(artifact_path)
                art["meta"].update(self._meta(meta))
        pending = [s for s in scenarios if s.scenario_id() not in done]
        skipped = len(scenarios) - len(pending)
        if skipped:
            self.progress(f"resume: {skipped} scenario(s) already in "
                          f"{artifact_path}, {len(pending)} to run")
        groups = group_scenarios(pending)
        for gi, (gkey, scens) in enumerate(groups.items()):
            label = group_label(gkey)
            if gkey[0] == "zoo":
                self.progress(f"[group {gi + 1}/{len(groups)}] {label}: "
                              f"{len(scens)} training run(s) x "
                              f"{scens[0].steps} step(s)")
                for s, record in zip(scens,
                                     self._run_train_group(scens, label)):
                    art["scenarios"][s.scenario_id()] = record
                if artifact_path and self._writes:
                    artifact_mod.save(art, artifact_path)
                continue
            chunks = self._chunks(scens)
            tag = (f" in {len(chunks)} chunk(s) of <= {self.chunk_size}"
                   if len(chunks) > 1 else "")
            self.progress(f"[group {gi + 1}/{len(groups)}] {label}: "
                          f"{len(scens)} scenario(s) x {scens[0].reps} reps"
                          f"{tag}")
            for ci, chunk in enumerate(chunks):
                t0 = time.perf_counter()
                outs = [self._run_one(s) for s in chunk]
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t0
                for s, (arrs, aux, launches) in zip(chunk, outs):
                    sid = s.scenario_id()
                    self.launches[sid] = launches
                    thetas = {"cq": arrs.theta_cq, "os": arrs.theta_os,
                              "qn": arrs.theta_qn}
                    art["scenarios"][sid] = {
                        "scenario": s.to_json(),
                        "metrics": compute_metrics(s, thetas, aux),
                        "spend": _spend_record(
                            s, arrs.sigmas[0].cpu().numpy()),
                        "comm": comm_record(s.p, s.protocol_config()),
                        "thetas_qn": (arrs.theta_qn.cpu().double()
                                      .tolist() if store_thetas else None),
                        "timing": {"group": label, "group_seconds": dt,
                                   "group_size": len(chunk), "chunk": ci,
                                   "n_chunks": len(chunks),
                                   "launches": launches},
                    }
                if artifact_path and self._writes:
                    # per-chunk atomic write: an interrupted oversized
                    # group resumes from its completed chunks
                    artifact_mod.save(art, artifact_path)
        artifact_mod.validate(art)
        return art

    def _chunks(self, scens: List[Scenario]) -> List[List[Scenario]]:
        """Split one group into bounded scenario batches."""
        c = self.chunk_size
        if c is None or len(scens) <= c:
            return [scens]
        return [scens[i:i + c] for i in range(0, len(scens), c)]

    @property
    def _writes(self) -> bool:
        """Rank 0 writes the artifact (every rank reads it to resume)."""
        return self.machine_map.rank == 0

    def _meta(self, meta: Optional[Dict]) -> Dict:
        cuda = self.device.type == "cuda"
        if self.mesh is not None:
            n_devices = self.machine_map.world
        else:
            n_devices = torch.cuda.device_count() if cuda else 1
        out = {"torch": torch.__version__,
               "device": torch.cuda.get_device_name(self.device) if cuda
               else "cpu",
               "n_devices": n_devices}
        out.update(meta or {})
        return out


def run_scenarios(scenarios: Iterable[Scenario], device=None,
                  artifact_path: Optional[str] = None, resume: bool = True,
                  store_thetas: bool = True, meta: Optional[Dict] = None,
                  progress: Optional[Callable[[str], None]] = None,
                  chunk_size: Optional[int] = None, mesh=None) -> Dict:
    """One-shot convenience wrapper around :class:`SweepExecutor`."""
    executor = SweepExecutor(device=device, progress=progress,
                             chunk_size=chunk_size, mesh=mesh)
    return executor.run(scenarios, artifact_path=artifact_path,
                        resume=resume, store_thetas=store_thetas, meta=meta)


def _spend_record(s: Scenario, sigmas: np.ndarray) -> Dict:
    """Host-side exact privacy spend for the artifact (schema v3): the
    accountant that certified the per-round budget, its sigma ratio vs
    basic composition, and the per-transmission sensitivity failure
    probabilities (nonzero for every transmission under the "subexp"
    high-probability accountant)."""
    cfg = s.protocol_config()
    k = n_transmissions(cfg)
    acct = privacy.get_accountant(s.accountant)
    eps_r, delta_r = acct.per_round(s.eps, s.delta, k)
    probs = _failure_probs(cfg, s.p, s.n)
    return {"eps_total": s.eps, "delta_total": s.delta,
            "n_transmissions": k, "eps_per_round": eps_r,
            "delta_per_round": delta_r,
            "sigmas": [float(v) for v in sigmas],
            "accountant": acct.name,
            "sigma_ratio_vs_basic":
                privacy.multiplier_ratio(s.accountant, s.eps, s.delta, k),
            "failure_probs": [float(f) for f in probs],
            "failure_prob_total": min(1.0, float(sum(probs)))}


def _train_spend_record(s: TrainScenario, params) -> Dict:
    """Per-STEP spend of one zoo training run, with the per-leaf ledger:
    every transmission's sigma at every leaf's own dimension
    (``core.dp.tree_spend_ledger``)."""
    k = len(dp.TREE_TRANSMISSIONS)
    if s.eps <= 0:
        return {"eps_total": 0.0, "delta_total": 0.0, "n_transmissions": k,
                "eps_per_round": 0.0, "delta_per_round": 0.0,
                "sigmas": [0.0] * k, "accountant": s.accountant,
                "sigma_ratio_vs_basic": 1.0, "per_leaf": []}
    acct = privacy.get_accountant(s.accountant)
    eps_r, delta_r = acct.per_round(s.eps, s.delta, k)
    ledger = dp.tree_spend_ledger(params, s.n_per_machine(), s.eps,
                                  s.delta, (s.gamma,) * 5, s.tail,
                                  accountant=s.accountant)
    sig_max = {name: max(r["sigma"] for r in ledger
                         if r["transmission"] == name)
               for name in dp.TREE_TRANSMISSIONS}
    return {"eps_total": s.eps, "delta_total": s.delta,
            "n_transmissions": k, "eps_per_round": eps_r,
            "delta_per_round": delta_r,
            "sigmas": [sig_max[name] for name in dp.TREE_TRANSMISSIONS],
            "accountant": acct.name,
            "sigma_ratio_vs_basic":
                privacy.multiplier_ratio(s.accountant, s.eps, s.delta, k),
            "per_leaf": ledger}
