"""Model configuration: the fields of ``repro/models/config.py`` that a
dense decoder reads (MoE, SSM and hybrid families are not ported yet)."""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # only "dense" is ported
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0               # 0 => d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e6
    d_ff: int = 0
    sliding_window: int = 0         # causal window (0 = full attention)
    norm_eps: float = 1e-6
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    q_chunk: int = 1024             # online-softmax attention chunks
    kv_chunk: int = 512
    remat: bool = True              # recompute each layer in backward

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def padded_vocab(self, multiple: int = 16) -> int:
        return ((self.vocab + multiple - 1) // multiple) * multiple


def n_params(cfg: ModelConfig) -> int:
    """Analytic parameter count of a dense model (matches init exactly)."""
    if cfg.arch_type != "dense":
        raise NotImplementedError(f"{cfg.arch_type} models are not ported")
    D, V = cfg.d_model, cfg.padded_vocab()
    hd = cfg.hd
    per_attn = (D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * D)
    if cfg.qk_norm:
        per_attn += 2 * hd
    per_mlp = 3 * D * cfg.d_ff
    return V * D + D + D * V + cfg.n_layers * (per_attn + per_mlp + 2 * D)
