"""Synthetic LM token corpus, port of the LM half of
``repro/data/synthetic.py``.  The same Markov-Zipf process from the same
``jax.random`` draws (:mod:`repro_torch.random`), so the same seed gives
the reference's tokens."""
from __future__ import annotations

import torch

from .. import random
from ..device import resolve_device

_ZIPF_EXPONENT = float(torch.tensor(0.7, dtype=torch.float32))


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
