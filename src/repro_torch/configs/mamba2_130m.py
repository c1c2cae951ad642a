"""Mamba2-130M [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", arch_type="ssm",
    n_layers=24, d_model=768, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
