"""Phi-3.5-MoE (42B, 6.6B active) [moe]: 16 experts, top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", arch_type="moe",
    n_layers=32, d_model=4096, vocab=32064,
    n_heads=32, n_kv_heads=8, head_dim=128,
    n_experts=16, top_k=2, moe_d_ff=6400,
    rope_theta=1e4,
)
