"""recurrentgemma-9b [hybrid] — 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention 1:2 (pattern r,r,local), window 2048.
O(1)/O(window) state -> runs the long_500k cell.  [arXiv:2402.19427]"""
from ..models.config import (BLOCK_LOCAL_ATTN, BLOCK_RECURRENT,
                             FAMILY_HYBRID, ModelConfig)

CONFIG = ModelConfig(
    arch_id="recurrentgemma-9b",
    family=FAMILY_HYBRID,
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=(BLOCK_RECURRENT, BLOCK_RECURRENT, BLOCK_LOCAL_ATTN),
    local_window=2048,
    lru_width=4096,
    rope_theta=10_000.0,
)
