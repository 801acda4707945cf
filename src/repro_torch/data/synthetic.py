"""Synthetic regression data (paper §5.1) — ``repro/data/synthetic.py``
counterpart, on a ``torch.Generator``.

The designs follow the paper exactly:
  * X ~ N(0, Sigma_T), Sigma_T Toeplitz with entry rho^{|i-j|}, rho = 0.6;
  * theta* = p^{-1/2} (1/2, ..., 1/2);
  * logistic: Y ~ Bernoulli(sigmoid(X theta*));
  * Poisson:  X resampled until |X theta*| <= 1, Y ~ Poisson(exp(X theta*)).

This is the reference's distribution, not its bits: torch cannot
reproduce ``jax.random``. ``digits_like_dataset`` is the exception: it
draws from numpy's ``default_rng`` on the host, as the reference does,
so its arrays equal the reference's bit for bit. Every generator draws a
whole batch of shards at once: ``shape`` is the leading shape, ``(m+1,)``
for ``make_shards``.
``make_shards`` lays data out as (m+1, n, ...) with machine 0 the center.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def toeplitz_cov(p: int, rho: float = 0.6, device=None) -> torch.Tensor:
    idx = torch.arange(p, device=resolve_device(device))
    return rho ** (idx[:, None] - idx[None, :]).abs().to(torch.float32)


def target_theta(p: int, device=None) -> torch.Tensor:
    return torch.full((p,), 0.5, device=resolve_device(device)) \
        / torch.sqrt(torch.tensor(float(p)))


def sample_x(generator: torch.Generator, shape, n: int, p: int,
             rho: float = 0.6) -> torch.Tensor:
    """``(*shape, n, p)`` rows of N(0, Toeplitz(rho))."""
    dev = generator.device
    chol = torch.linalg.cholesky(toeplitz_cov(p, rho, dev))
    z = torch.randn(tuple(shape) + (n, p), generator=generator, device=dev)
    return z @ chol.T


def logistic_data(generator: torch.Generator, shape, n: int, p: int,
                  rho: float = 0.6) -> Tuple[torch.Tensor, torch.Tensor]:
    X = sample_x(generator, shape, n, p, rho)
    prob = torch.sigmoid(X @ target_theta(p, generator.device))
    y = torch.bernoulli(prob, generator=generator)
    return X, y


def poisson_data(generator: torch.Generator, shape, n: int, p: int,
                 rho: float = 0.6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Truncated design: rows with |x.theta*| > 1 are dropped (paper Exp
    2), by oversampling 3x and taking the first n valid rows of each
    shard (>90% of draws are valid, so 3x is far more than enough)."""
    theta = target_theta(p, generator.device)
    X_big = sample_x(generator, shape, 3 * n, p, rho)
    valid = (X_big @ theta).abs() <= 1.0
    order = torch.sort((~valid).to(torch.uint8), dim=-1, stable=True).indices
    X = torch.gather(X_big, -2, order[..., :n, None].expand(
        order.shape[:-1] + (n, p)))
    y = torch.poisson(torch.exp(X @ theta), generator=generator)
    return X, y


def linear_data(generator: torch.Generator, shape, n: int, p: int,
                rho: float = 0.6,
                noise: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    X = sample_x(generator, shape, n, p, rho)
    e = torch.randn(tuple(shape) + (n,), generator=generator,
                    device=generator.device)
    return X, X @ target_theta(p, generator.device) + noise * e


_GENERATORS = {"logistic": logistic_data, "poisson": poisson_data,
               "linear": linear_data}


def make_shards(generator: torch.Generator, model: str, m: int, n: int,
                p: int, rho: float = 0.6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m+1, n, p) X and (m+1, n) y on the generator's device; machine 0
    is the central processor."""
    return _GENERATORS[model](generator, (m + 1,), n, p, rho)


def token_batches(seed: int, vocab: int, batch: int, seq: int,
                  n_batches: int, device=None):
    """Deterministic synthetic token stream with a learnable structure:
    next token = (3*tok + 7) % vocab with 10% uniform noise, so a model can
    visibly reduce loss within a few hundred steps. Batch i is drawn from
    the ``batches`` stream of ``seed`` at index i (``core.keys``), on
    ``device`` (the card unless given); yields (batch, seq) int64
    ``(inputs, labels)``, the labels the inputs shifted by one."""
    from repro_torch.core.keys import stream_generator
    from repro_torch.data.lm import markov_chain
    device = resolve_device(device)
    for i in range(n_batches):
        g = stream_generator(seed, "batches", i, device)
        kw = dict(generator=g, device=device)
        first = torch.randint(0, vocab, (batch, 1), **kw)
        keep = torch.rand((batch, seq), **kw) >= 0.1
        noise = torch.randint(0, vocab, (batch, seq), **kw)
        toks = markov_chain(first, keep, noise, vocab, a=3, c=7)
        yield toks[:, :seq], toks[:, 1:]


def digits_like_dataset(seed: int, n: int, n_features: int = 50,
                        pair: Tuple[int, int] = (8, 9), device=None):
    """Deterministic stand-in for the MNIST pairs experiment (§5.2): two
    Gaussian classes whose means differ on a sparse subset of features,
    with heavier overlap for 'hard' pairs (the repository fetches no
    data). ``(X (n, n_features), y (n,))`` float32 on the device, and the
    informative feature indices (numpy)."""
    rng = np.random.default_rng(seed + 100 * pair[0] + pair[1])
    hard = {(8, 9): 1.6, (6, 8): 1.2, (6, 9): 1.0}.get(tuple(sorted(pair)),
                                                       1.2)
    mean_gap = 1.0 / hard
    k_informative = 8
    mu = np.zeros(n_features)
    informative = rng.choice(n_features, size=k_informative, replace=False)
    mu[informative] = mean_gap * rng.choice([-1.0, 1.0], size=k_informative)
    y = rng.integers(0, 2, size=n)
    X = rng.normal(size=(n, n_features)) + np.outer(2 * y - 1, mu)
    dev = resolve_device(device)
    return (torch.from_numpy(X.astype(np.float32)).to(dev),
            torch.from_numpy(y.astype(np.float32)).to(dev), informative)
