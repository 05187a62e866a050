"""qwen3-4b [dense] — 36L d_model=2560 32H (GQA kv=8) d_ff=9728
vocab=151936, qk_norm, explicit head_dim=128.  [hf:Qwen/Qwen3-4B]"""
from ..models.config import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen3-4b",
    family=FAMILY_DENSE,
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
