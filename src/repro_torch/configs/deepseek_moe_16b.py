"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) vocab=102400,
fine-grained MoE: 64 routed experts (d_ff=1408 each) top-6 + 2 shared
experts; layer 0 is a dense FFN (d_ff=10944).  [arXiv:2401.06066]"""
from ..models.config import FAMILY_MOE, ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-moe-16b",
    family=FAMILY_MOE,
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # routed-expert width (assignment table value)
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    expert_d_ff=1408,
    first_dense_layers=1,
    dense_d_ff=10944,        # hf intermediate_size for the dense first layer
    rope_theta=10_000.0,
)
