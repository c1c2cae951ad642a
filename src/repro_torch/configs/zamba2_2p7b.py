"""Zamba2-2.7B [hybrid]: Mamba2 backbone + one shared attention block applied
every 6 layers. [arXiv:2411.15242]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    n_layers=54, d_model=2560, vocab=32000,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    attn_every=6, rope_theta=1e4,
)
