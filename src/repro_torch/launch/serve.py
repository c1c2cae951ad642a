"""Serving steps: prefill and one-token decode, port of
``repro/launch/serve.py`` on one device.

The greedy steps keep the argmax on the device: only the ``[B, 1]`` int32
token ids cross to the host, and only when the caller reads them.  The
token is ``argmax(logits[:, -1:]) % vocab``; ``torch.argmax`` takes the
first index on ties, as ``jnp.argmax`` does.  The reference's
``serve_specs`` (PartitionSpecs for lowering on a TPU mesh) has no
counterpart here.
"""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.model import decode_step, prefill


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """``(params, tokens [B,S]) -> (last-position logits, cache)``."""
    def prefill_step(params, tokens):
        return prefill(params, tokens, cfg, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``(params, cache, tokens [B,1]) -> (logits, cache)``."""
    def serve_step(params, cache, tokens):
        return decode_step(params, cache, tokens, cfg)
    return serve_step


def _greedy(logits, cfg: ModelConfig):
    return torch.argmax(logits[:, -1:], dim=-1).to(torch.int32) % cfg.vocab


def make_greedy_decode_step(cfg: ModelConfig):
    """``(params, cache, tokens [B,1]) -> (next tokens [B,1] int32,
    cache)``."""
    def greedy_step(params, cache, tokens):
        logits, cache = decode_step(params, cache, tokens, cfg)
        return _greedy(logits, cfg), cache
    return greedy_step


def make_greedy_prefill_step(cfg: ModelConfig, max_len: int):
    """``(params, tokens [B,S]) -> (first greedy token [B,1] int32,
    cache)``."""
    def greedy_prefill(params, tokens):
        logits, cache = prefill(params, tokens, cfg, max_len)
        return _greedy(logits, cfg), cache
    return greedy_prefill


def jit_serve(cfg: ModelConfig, max_len: int):
    """``(greedy prefill, greedy decode)`` for the serve loop.

    The name is the reference's; here both steps run eagerly (nothing is
    compiled).  The decode step writes the KV cache in place, the
    counterpart of the reference's donated cache: callers treat the cache
    they pass as consumed and rebind to the one the step returns.
    """
    return make_greedy_prefill_step(cfg, max_len), make_greedy_decode_step(cfg)
