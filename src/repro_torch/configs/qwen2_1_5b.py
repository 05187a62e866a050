"""qwen2-1.5b [dense] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936, GQA + QKV bias, tied embeddings.  [arXiv:2407.10671]"""
from ..models.config import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-1.5b",
    family=FAMILY_DENSE,
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
