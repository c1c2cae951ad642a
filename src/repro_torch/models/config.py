"""Model configuration: port of ``repro/models/config.py`` for every family
of the reference (dense, moe, vlm, audio, and the Mamba2 families ssm and
hybrid).  ``scan_layers`` is not ported: it is a JAX compile switch (the
port runs its layers as a Python loop either way).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

ATTENTION_FAMILIES = ("dense", "moe", "vlm", "audio")
FAMILIES = ATTENTION_FAMILIES + ("ssm", "hybrid")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
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
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_n_groups: int = 1
    ssm_chunk: int = 128            # SSD intra-chunk quadratic block size
    # hybrid: run the shared attention block after every `attn_every` layers
    attn_every: int = 0
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

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def conv_channels(self) -> int:
        return self.d_inner + 2 * self.ssm_n_groups * self.ssm_state

    @property
    def has_attention(self) -> bool:
        return self.n_heads > 0 or self.attn_every > 0

    @property
    def is_recurrent(self) -> bool:
        """O(1)-in-seq decode state (SSM/hybrid)."""
        return self.arch_type in ("ssm", "hybrid")

    def padded_vocab(self, multiple: int = 16) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple


def check_family(cfg: ModelConfig):
    """Refuses an unknown family."""
    if cfg.arch_type not in FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}; have "
                         f"{FAMILIES}")


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
    total = V * D + D + D * V                   # embed, final norm, lm head
    if cfg.arch_type in ATTENTION_FAMILIES:
        return total + cfg.n_layers * (per_attn + per_ffn + 2 * D)
    di, H, GN = cfg.d_inner, cfg.ssm_heads, cfg.ssm_n_groups * cfg.ssm_state
    cc = cfg.conv_channels
    per_mamba = (D * (2 * di + 2 * GN + H)      # w_z, w_x, w_B, w_C, w_dt
                 + cfg.ssm_conv * cc + cc       # conv weights and biases
                 + 3 * H                        # A_log, Dp, dt_bias
                 + di                           # gate_norm
                 + di * D)                      # out_proj
    total += cfg.n_layers * (per_mamba + D)     # mamba blocks and their ln
    if cfg.arch_type == "hybrid":               # one shared attention block
        total += per_attn + per_ffn + 2 * D
    return total


def n_active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top_k of n_experts)."""
    if not cfg.n_experts:
        return n_params(cfg)
    return n_params(cfg) - cfg.n_layers * (_per_moe(cfg, cfg.n_experts)
                                           - _per_moe(cfg, cfg.top_k))
