"""Qwen3-30B-A3B [moe]: 128 experts, top-8, per-expert ffn 768.
[hf:Qwen/Qwen3-30B-A3B]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", arch_type="moe",
    n_layers=48, d_model=2048, vocab=151936,
    n_heads=32, n_kv_heads=4, head_dim=128,
    n_experts=128, top_k=8, moe_d_ff=768,
    qk_norm=True, rope_theta=1e6,
)
