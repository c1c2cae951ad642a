"""Architecture registry of the port: the reference's published configs of
the attention families (dense, moe, vlm, audio).

``get_config(arch_id)`` returns the published configuration;
``smoke_config(cfg)`` the reduced same-family variant of the CPU tests,
with the reference's reductions.  ``mamba2-130m`` and ``zamba2-2.7b``
(ssm, hybrid) are not ported yet (ROADMAP.md queue 1, item 1).
"""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

_MODULES = {
    "qwen3-8b": "qwen3_8b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "yi-6b": "yi_6b",
    "chameleon-34b": "chameleon_34b",
    "musicgen-medium": "musicgen_medium",
    "yi-9b": "yi_9b",
    "phi3.5-moe-42b-a6.6b": "phi3p5_moe_42b",
    "stablelm-1.6b": "stablelm_1p6b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"{arch_id!r} is not ported; have {ARCH_IDS}")
    return importlib.import_module(f"{__name__}.{_MODULES[arch_id]}").CONFIG


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (2 layers, d_model
    256, vocab <= 512, 4 heads of 32, <= 4 experts of width 64)."""
    kw = dict(name=cfg.name + "-smoke", n_layers=2, d_model=256,
              vocab=min(cfg.vocab, 512), q_chunk=32, kv_chunk=16)
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=min(4, max(1, cfg.n_kv_heads)),
                  head_dim=32, d_ff=256 if cfg.d_ff else 0)
    if cfg.n_experts:
        kw.update(n_experts=4, top_k=min(2, cfg.top_k), moe_d_ff=64)
    if cfg.sliding_window:
        kw.update(sliding_window=64)
    return dataclasses.replace(cfg, **kw)
