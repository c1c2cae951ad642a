"""Yi-6B [dense]: llama-arch GQA. [arXiv:2403.04652]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", arch_type="dense",
    n_layers=32, d_model=4096, vocab=64000,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=11008,
    rope_theta=5e6,
)
