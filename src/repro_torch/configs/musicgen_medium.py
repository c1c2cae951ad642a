"""MusicGen-medium [audio]: decoder-only over EnCodec tokens; the EnCodec
conv codec frontend is a stub per the carve-out (ids are precomputed
codebook indices; the 4 codebook streams are flattened to one — backbone
unchanged). [arXiv:2306.05284]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", arch_type="audio",
    n_layers=48, d_model=1536, vocab=2048,
    n_heads=24, n_kv_heads=24, head_dim=64, d_ff=6144,
    rope_theta=1e4,
    frontend="encodec",
)
