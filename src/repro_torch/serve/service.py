"""The streaming aggregation service — ``repro/serve/service.py``
counterpart.

Machine updates (Algorithm-1 p-vectors or parameter trees) arrive through
:meth:`AggregationService.submit` / ``submit_many``, land in a
fixed-capacity :class:`RingBuffer` on the device, and a flush runs
whenever the :class:`FlushPolicy` fires (buffer full, deadline, or an
explicit ``flush()``):

    noise (central DP, per-leaf calibrated)  ->  masked robust
    aggregation of the valid prefix (repro_torch.agg.aggregate_masked)
    ->  theta <- theta - lr * aggregate

The flush works one leaf at a time (noise, aggregate, update), so a tree
the size of a large model needs one leaf's working memory beyond the
buffer and theta. On the card the order-statistics rules (median, dcq,
dcq_mad) aggregate each leaf with one launch of the kernel on the
buffer's prefix. Theta is updated in place, in its own dtype. Every
served round appends to the DP spend ledger: one composition entry on the
:class:`PrivacyAccountant` and per-leaf ``{transmission, leaf, dim, sigma,
eps, delta, ...}`` records.

Noise: round r draws from a generator on the device seeded with
``repro_torch.core.keys.stream_seed(cfg.seed, "serve", r)``, a hash of
``(seed, stream, r)``, so no two (seed, round) pairs share a stream. Only
the prefix's rows are noised (the reference noises the stale tail too; the
aggregate and the ledger are the same either way). ``flush(noise=...)``
takes the standard normals instead, as ``protocol_rounds(noise=)`` does.

Across ranks (``sharding=mesh``): the ring buffer's capacity axis is
split over the mesh's ranks (:class:`RingBuffer`), every rank ingests the
same arrivals, and a flush first checks that every rank holds the same
fill, then per leaf gathers the rows in machine order
(``dist.collectives.gather_machines``), takes the prefix, draws the
round's noise (the same on every rank), aggregates and updates theta,
which is replicated, freeing the gathered leaf before the next one. At a
world of 1 the gather is a copy, so the result equals the unsharded
service's bit for bit.

The clock is ``time.perf_counter`` of this module's ``time``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch

from repro_torch import obs, resolve_device
from repro_torch.core.dp import PrivacyAccountant, tree_mean_sigma
from repro_torch.core.keys import stream_generator
from repro_torch.core.transport import (leaf_paths, tree_flatten,
                                        tree_leaf_dims, tree_leaves,
                                        tree_map, tree_unflatten,
                                        wire_aggregate)
from repro_torch.dist.collectives import gather_machines
from repro_torch.privacy import get_accountant, multiplier_ratio
from repro_torch.serve.buffers import RingBuffer
from repro_torch.serve.flush import FlushPolicy

__all__ = ["ServeConfig", "AggregationService"]


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static configuration of one service instance (the reference's
    fields and defaults)."""
    #: registered repro_torch.agg rule; must have a masked form.
    method: str = "dcq_mad"
    #: ring-buffer slots (the largest fleet one round aggregates).
    capacity: int = 1024
    #: per-coordinate scale (a number or a tree) for needs_scale rules.
    scale: Any = None
    K: int = 10
    trim_beta: float = 0.2
    #: model update: theta <- theta - lr * aggregate.
    lr: float = 1.0
    #: central-DP budget per served round; > 0 adds per-leaf calibrated
    #: Gaussian noise to the buffered updates.
    eps: float = 0.0
    delta: float = 1e-6
    #: samples per machine (the mean-mechanism sensitivity, Lemma 4.4).
    dp_n: int = 100
    dp_gamma: float = 2.0
    dp_tail: str = "subexp"
    #: bulk-ingest chunk: one in-place block write per this many rows.
    ingest_block: int = 64
    #: root seed of the per-round noise generators ("serve" stream).
    seed: int = 0
    #: repro_torch.privacy accountant; the serving wire is ONE
    #: transmission per round (k = 1).
    accountant: str = "basic"
    #: masked aggregation form: "sort", "bisect", or None (bisect on the
    #: card where the rule has one, sort otherwise).
    masked_backend: Optional[str] = None


class AggregationService:
    """Robust-DP aggregation over a streaming fleet.

    ``theta`` is the served model (a tensor or a tree of tensors); arriving
    updates must match its structure. It is moved to ``device`` (the card
    unless given) and updated in place there. ``sharding`` (a 1-D machine
    mesh) splits the ring buffer's capacity axis over its ranks."""

    def __init__(self, theta: Any, cfg: ServeConfig = ServeConfig(),
                 policy: Optional[FlushPolicy] = None, device=None,
                 sharding: Optional[Any] = None):
        self.cfg = cfg
        self.policy = policy if policy is not None else FlushPolicy()
        self.device = resolve_device(device)
        self.theta = tree_map(lambda x: x.to(self.device), theta)
        self.buffer = RingBuffer(self.theta, cfg.capacity,
                                 block=cfg.ingest_block, device=self.device,
                                 sharding=sharding)
        self.round_idx = 0
        self.accountant = PrivacyAccountant()
        self.ledger: list = []      # per-leaf spend records, every round
        self.history: list = []     # per-round {round, fill, latency_s, ..}
        self.rejected = 0
        self._oldest_ts: Optional[float] = None

        # per-leaf noise calibration: the serving wire is ONE transmission
        # per round, so each flush spends the whole (eps, delta) on one
        # mean-mechanism release per leaf.
        dims = tree_leaf_dims(self.theta)
        self._paths = leaf_paths(self.theta)
        self._dims = [int(d) for d in tree_leaves(dims)]
        self._acct = get_accountant(cfg.accountant)   # validates the name
        self._sigma = None
        if cfg.eps > 0:
            self._sigma = tree_mean_sigma(dims, cfg.dp_n, cfg.dp_gamma,
                                          cfg.eps, cfg.delta, cfg.dp_tail)
            if cfg.accountant != "basic":
                ratio = multiplier_ratio(cfg.accountant, cfg.eps,
                                         cfg.delta, 1)
                if ratio != 1.0:
                    self._sigma = tree_map(lambda s: s * ratio, self._sigma)

    # ------------------------------------------------------------- state

    @property
    def fill(self) -> int:
        return self.buffer.fill

    def _age_s(self) -> float:
        if self._oldest_ts is None:
            return 0.0
        return time.perf_counter() - self._oldest_ts

    # ------------------------------------------------------------ ingest

    def submit(self, update: Any) -> bool:
        """One machine update. Returns False iff the buffer is full, the
        policy does not flush, and backpressure is "reject"."""
        if self.buffer.full:
            if self.policy.should_flush(self.fill, self.cfg.capacity,
                                        self._age_s()):
                self.flush()
            elif self.policy.backpressure == "reject":
                self.rejected += 1
                return False
            # "overwrite": fall through; the ring wraps onto the oldest.
        if self.buffer.fill == 0:
            self._oldest_ts = time.perf_counter()
        self.buffer.push(update)
        self._maybe_flush()
        return True

    def submit_many(self, updates: Any) -> int:
        """Bulk ingest of stacked updates (leading axis = machines): whole
        ``ingest_block`` chunks go through one block write each, the rest
        through the row path. Returns how many were accepted."""
        n = tree_leaves(updates)[0].shape[0]
        block = self.buffer.block
        i = accepted = 0
        with obs.span("repro.serve.submit"):
            while i < n:
                room = self.cfg.capacity - self.fill
                if room >= block and (n - i) >= block:
                    if self.buffer.fill == 0:
                        self._oldest_ts = time.perf_counter()
                    self.buffer.push_block(updates, i)
                    i += block
                    accepted += block
                    self._maybe_flush()
                else:
                    if self.submit(tree_map(lambda x: x[i], updates)):
                        accepted += 1
                    elif self.policy.backpressure == "reject":
                        self.rejected += n - i - 1
                        return accepted
                    i += 1
        return accepted

    # ------------------------------------------------------------- flush

    def _maybe_flush(self) -> None:
        if self.policy.should_flush(self.fill, self.cfg.capacity,
                                    self._age_s()):
            self.flush()

    def poll(self) -> Optional[Any]:
        """Deadline tick: flush iff the policy says the buffered updates
        have waited long enough. Call from the serving loop's idle path."""
        if self.fill >= self.policy.min_fill and self._age_s() > 0 \
                and self.policy.max_delay_s is not None \
                and self._age_s() >= self.policy.max_delay_s:
            return self.flush()
        return None

    def flush(self, noise: Any = None) -> Optional[Any]:
        """Aggregate the buffered prefix and update theta. Returns the
        round's aggregate (theta's structure), or None when the buffer
        holds fewer than ``min_fill`` updates.

        ``noise``: standard normals per leaf, a tree matching theta of
        ``(capacity, *leaf)`` tensors of which the first ``fill`` rows are
        used, in place of the round's own draws.

        On a sharded buffer every rank must call it (a collective); it
        raises where the ranks' fills differ."""
        fill = self.fill
        if fill < self.policy.min_fill:
            return None
        with obs.span("repro.serve.flush"):
            self.buffer.check_fill()
            mesh = self.buffer.mesh
            cfg = self.cfg
            noised = self._sigma is not None
            t0 = time.perf_counter()
            buffers, treedef = tree_flatten(self.buffer.arrays)
            thetas = tree_leaves(self.theta)
            sigmas = tree_leaves(self._sigma) if noised \
                else [0.0] * len(buffers)
            zs = tree_leaves(noise) if noise is not None \
                else [None] * len(buffers)
            gen = stream_generator(cfg.seed, "serve", self.round_idx,
                                   self.device) if noised and noise is None \
                else None
            scales = tree_leaves(cfg.scale) \
                if isinstance(cfg.scale, (dict, list, tuple)) \
                else [cfg.scale] * len(buffers)
            out = []
            for buf, th, sig, z, sc in zip(buffers, thetas, sigmas, zs,
                                           scales):
                if mesh is not None:
                    # the whole capacity axis in machine order, this leaf
                    # only
                    buf = gather_machines(buf, mesh)
                rows = buf[:fill]
                if noised:
                    if z is None:
                        z = torch.randn(rows.shape, generator=gen,
                                        dtype=rows.dtype,
                                        device=self.device).mul_(sig)
                    else:
                        # repro-torch: allow(step-sync) — the
                        # flush(noise=) parity hook only; the service's own
                        # draws are made on the device
                        z = z[:fill].to(dtype=rows.dtype,
                                        device=self.device) * sig
                    # rows + (sigma * z), two roundings as the reference's;
                    # the draws are freed before the aggregation's working
                    # copy
                    rows.add_(z)
                    del z
                red = wire_aggregate(buf, cfg.method, scale=sc, K=cfg.K,
                                     trim_beta=cfg.trim_beta,
                                     backend=cfg.masked_backend, fill=fill)
                th.add_(red * -cfg.lr)
                out.append(red)
                del buf, rows
            if self.device.type == "cuda":
                with obs.span("repro.serve.sync"):
                    # repro-torch: allow(step-sync) — deliberate: the
                    # flush's latency is taken when the card has finished
                    # (the sync debug mode does not report this call)
                    torch.cuda.synchronize(self.device)
            now = time.perf_counter()

            if noised:
                self.accountant.spend_tree(f"serve round {self.round_idx}",
                                           cfg.eps, cfg.delta, self._sigma)
            self.ledger.extend(
                {"transmission": f"serve round {self.round_idx}", "leaf": p,
                 # repro-torch: allow(step-sync) — host-only: the ledger's
                 # sigmas are Python floats
                 "dim": d, "sigma": float(s),
                 "eps": cfg.eps if noised else 0.0,
                 "delta": cfg.delta if noised else 0.0,
                 "noise": noised, "accountant": cfg.accountant,
                 **({"failure_prob": self._acct.failure_prob(d, cfg.dp_n,
                                                             cfg.dp_gamma)}
                    if self._acct.failure_prob is not None and noised
                    else {})}
                for p, d, s in zip(self._paths, self._dims, sigmas))
            self.history.append({
                "round": self.round_idx, "fill": fill,
                "latency_s": now - (self._oldest_ts
                                    if self._oldest_ts is not None else t0),
                "flush_s": now - t0,
            })
            self.round_idx += 1
            self.buffer.reset()
            self._oldest_ts = None
            return tree_unflatten(treedef, out)
