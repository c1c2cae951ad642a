"""Model configuration: port of ``repro/models/config.py`` for the attention
families (dense, moe, vlm, audio).  The SSM and hybrid families, and their
fields, are not ported yet (ROADMAP.md queue 1, item 1: Mamba2 and hybrid).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    d_ff: int = 0
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert hidden dim
    # GSPMD placement knobs of the reference (token sub-groups per data
    # shard; attention resharded over the batch).  Kept so that a config
    # compares field by field with the reference's; the port's compute
    # does not read them.
    moe_groups_per_shard: int = 8
    capacity_factor: float = 1.25
    attn_batch_shard: bool = False
    moe_combine: str = "gather"     # "gather" | "scatter" (models/moe.py)
    sliding_window: int = 0         # causal window (0 = full attention)
    norm_eps: float = 1e-6
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 1024             # online-softmax attention chunks
    kv_chunk: int = 512
    remat: bool = True              # recompute each layer in backward
    # [vlm]/[audio]: token ids are precomputed codebook ids (the frontend
    # is a stub in the reference too); the backbone consumes ids like any LM
    frontend: Optional[str] = None  # "vq_image" | "encodec" | None

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def padded_vocab(self, multiple: int = 16) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple


def check_family(cfg: ModelConfig):
    """Refuses the families the port does not run."""
    if cfg.arch_type in ("ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.arch_type} models are not ported (ROADMAP.md queue 1, "
            "item 1: Mamba2 and hybrid)")
    if cfg.arch_type not in ATTENTION_FAMILIES:
        raise ValueError(cfg.arch_type)


def _per_moe(cfg: ModelConfig, experts: int) -> int:
    D = cfg.d_model
    return D * cfg.n_experts + experts * 3 * D * cfg.moe_d_ff


def n_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (matches init exactly)."""
    check_family(cfg)
    D, V = cfg.d_model, cfg.padded_vocab()
    hd = cfg.hd
    per_attn = (D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * D)
    if cfg.qk_norm:
        per_attn += 2 * hd
    per_ffn = (_per_moe(cfg, cfg.n_experts) if cfg.arch_type == "moe"
               else 3 * D * cfg.d_ff)
    return V * D + D + D * V + cfg.n_layers * (per_attn + per_ffn + 2 * D)


def n_active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top_k of n_experts)."""
    if not cfg.n_experts:
        return n_params(cfg)
    return n_params(cfg) - cfg.n_layers * (_per_moe(cfg, cfg.n_experts)
                                           - _per_moe(cfg, cfg.top_k))
