"""Qwen3-8B [dense]: GQA + qk-norm. [hf:Qwen/Qwen3-8B]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", arch_type="dense",
    n_layers=36, d_model=4096, vocab=151936,
    n_heads=32, n_kv_heads=8, head_dim=128, d_ff=12288,
    qk_norm=True, rope_theta=1e6,
)
