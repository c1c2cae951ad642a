"""StableLM-2-1.6B [dense]. [hf:stabilityai/stablelm-2-1_6b]
(partial-rotary detail of the released model simplified to full rotary,
as in the reference config.)"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", arch_type="dense",
    n_layers=24, d_model=2048, vocab=100352,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=5632,
    rope_theta=1e4,
)
