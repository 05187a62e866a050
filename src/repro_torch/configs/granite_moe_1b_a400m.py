"""granite-moe-1b-a400m [moe] — 24L d_model=1024 16H (GQA kv=8), 32 routed
experts (d_ff=512) top-8, vocab=49155, tied embeddings.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from ..models.config import FAMILY_MOE, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m",
    family=FAMILY_MOE,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    n_shared_experts=0,
    top_k=8,
    expert_d_ff=512,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
