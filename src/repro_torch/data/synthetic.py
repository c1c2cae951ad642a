"""Synthetic LM token corpus, port of the LM half of
``repro/data/synthetic.py``.  The same Markov-Zipf process drawn from a
``torch.Generator``: it matches the reference in distribution, not in
bits (tests that need identical tokens draw them with the reference and
pass them through numpy)."""
from __future__ import annotations

import torch

from ..device import resolve_device


def synthetic_lm_batch(gen: torch.Generator, batch: int, seq: int, vocab: int,
                       device) -> dict:
    """Zipf-like marginal (inverse CDF) mixed half the time with a Markov
    step ``t -> (31 t + 7) mod V``: cheap, deterministic, learnable.
    Tokens are int64."""
    u = torch.rand((batch, seq + 1), generator=gen, device=device)
    zipf = torch.clamp(torch.clamp_min(u, 1e-6).reciprocal() ** 0.7,
                       max=float(vocab)) - 1
    base = zipf.to(torch.int64) % vocab
    mix = torch.rand((batch, seq + 1), generator=gen, device=device) < 0.5
    stream = torch.where(mix, (base * 31 + 7) % vocab, base)
    return {"tokens": stream[:, :-1], "targets": stream[:, 1:]}


def lm_worker_corpus(seed: int, n_workers: int, n_local: int, seq: int,
                     vocab: int, *, device="cuda") -> dict:
    """``{"tokens", "targets"}`` of shape ``[W, N_local, S]``; worker m's
    shard comes from its own generator, seeded from ``(seed, m)``, so the
    shards are heterogeneous across workers (the federated setting)."""
    dev = resolve_device(device)
    shards = []
    for m in range(n_workers):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed * 1_000_003 + m)
        shards.append(synthetic_lm_batch(gen, n_local, seq, vocab, dev))
    return {k: torch.stack([s[k] for s in shards]) for k in ("tokens",
                                                             "targets")}
