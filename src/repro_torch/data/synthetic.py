"""Synthetic data, port of ``repro/data/synthetic.py``: the paper's
MNIST-like classification mixture and its split over workers, and the LM
token corpus.  The same draws as ``jax.random`` (:mod:`repro_torch.random`),
so the same seed gives the reference's data bit for bit."""
from __future__ import annotations

import itertools
import math
from typing import Iterator, Optional

import torch

from .. import random
from ..device import resolve_device

_ZIPF_EXPONENT = float(torch.tensor(0.7, dtype=torch.float32))
F32 = torch.float32


# ---------------------------------------------------------------------------
# Paper-repro: MNIST-like classification mixture
# ---------------------------------------------------------------------------

def classification_dataset(key: torch.Tensor, *, n_per_class: int = 100,
                           n_classes: int = 10, n_features: int = 784,
                           separation: float = 2.0, noise: float = 1.0):
    """``(X [N, F], Y one-hot [N, C])``, float32, on the key's device: a
    Gaussian mixture with class ``c`` at row ``i`` for ``i mod C == c``.

    The reference runs eagerly, so nothing contracts: ``separation *
    normal`` and ``/ sqrt(F)`` are two float32 roundings, the second a
    true division (by a device tensor: torch on CUDA multiplies by the
    reciprocal of a Python scalar divisor)."""
    kc, kx = random.split(key)
    root = torch.tensor(math.sqrt(n_features), dtype=F32, device=key.device)
    centers = separation * random.normal(kc, (n_classes, n_features)) / root
    N = n_classes * n_per_class
    labels = torch.arange(n_classes, device=key.device).repeat(n_per_class)
    X = centers[labels] + noise * random.normal(kx, (N, n_features)) / root
    Y = torch.nn.functional.one_hot(labels, n_classes).to(F32)
    return X, Y


def split_workers(X: torch.Tensor, Y: torch.Tensor, n_workers: int, *,
                  heterogeneity: float = 0.0,
                  key: Optional[torch.Tensor] = None):
    """Shard a dataset over workers: ``(X [W, N // W, F], Y [W, N // W,
    C])``.  The first ``int(heterogeneity * N)`` rows are taken in label
    order (a stable sort, so label 0's rows first, each in row order), the
    rest in the order of ``permutation(key, N)`` with those rows removed:
    0 is a uniform shuffle, 1 is sorted by label (maximally non-iid).
    ``key`` defaults to ``PRNGKey(0)`` on X's device, as in the
    reference."""
    N = X.shape[0]
    if key is None:
        key = random.PRNGKey(0, device=X.device)
    labels = torch.argmax(Y, -1)
    shuffled = random.permutation(key, N).to(X.device)
    sorted_idx = torch.sort(labels, stable=True).indices
    head = sorted_idx[:int(heterogeneity * N)]
    idx = torch.cat([head, shuffled[~torch.isin(shuffled, head)]])[:N]
    per = N // n_workers
    idx = idx[:per * n_workers].reshape(n_workers, per)
    return X[idx], Y[idx]


# ---------------------------------------------------------------------------
# LM token pipeline
# ---------------------------------------------------------------------------


def synthetic_lm_batch(key: torch.Tensor, batch: int, seq: int,
                       vocab: int) -> dict:
    """Zipf-like marginal (inverse CDF of a uniform draw) mixed half the
    time with a Markov step ``t -> (31 t + 7) mod V``: cheap, deterministic,
    learnable.  Drawn on the key's device; tokens are int64.

    ``(1 / max(u, 1e-6)) ** 0.7`` is taken as the float64 power rounded to
    float32, which agrees with XLA's float32 power on more draws than
    torch's float32 power does; the tokens (after the clamp and the cast)
    are the reference's."""
    k1, k2 = random.split(key)
    u = random.uniform(k1, (batch, seq + 1))
    x = 1.0 / torch.clamp_min(u, 1e-6)
    zipf = torch.clamp_max((x.double() ** _ZIPF_EXPONENT).float(),
                           float(vocab)) - 1
    base = zipf.to(torch.int64) % vocab
    mix = random.bernoulli(k2, 0.5, (batch, seq + 1))
    stream = torch.where(mix, (base * 31 + 7) % vocab, base)
    return {"tokens": stream[:, :-1], "targets": stream[:, 1:]}


def lm_worker_corpus(seed: int, n_workers: int, n_local: int, seq: int,
                     vocab: int, *, device="cuda") -> dict:
    """``{"tokens", "targets"}`` of shape ``[W, N_local, S]``; worker m's
    shard is drawn from ``fold_in(PRNGKey(seed), m)``, so the shards are
    heterogeneous across workers (the federated setting)."""
    key0 = random.PRNGKey(seed, device=resolve_device(device))
    shards = [synthetic_lm_batch(random.fold_in(key0, m), n_local, seq, vocab)
              for m in range(n_workers)]
    return {k: torch.stack([s[k] for s in shards]) for k in ("tokens",
                                                             "targets")}


def lm_batches(seed: int, batch: int, seq: int, vocab: int, *,
               device="cuda") -> Iterator[dict]:
    """Infinite iterator of LM batches: step k draws
    ``synthetic_lm_batch(fold_in(PRNGKey(seed), k), ...)`` on ``device``.
    The reference's ``sharding`` argument (a ``jax.device_put`` target)
    has no counterpart: the batches are made where they are used."""
    key0 = random.PRNGKey(seed, device=resolve_device(device))
    return (synthetic_lm_batch(random.fold_in(key0, step), batch, seq, vocab)
            for step in itertools.count())
