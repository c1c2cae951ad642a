"""Chameleon-34B [vlm]: early-fusion backbone over VQ image + text tokens;
the VQ-VAE image tokenizer frontend is a stub per the carve-out (token ids
are precomputed codebook indices). Uses qk-norm as in the paper.
[arXiv:2405.09818]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", arch_type="vlm",
    n_layers=48, d_model=8192, vocab=65536,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=22016,
    qk_norm=True, rope_theta=1e4,
    frontend="vq_image",
)
