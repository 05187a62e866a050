"""granite-3-2b [dense] — 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155, tied embeddings.  [hf:ibm-granite/granite-3.0-2b-base]"""
from ..models.config import FAMILY_DENSE, ModelConfig

CONFIG = ModelConfig(
    arch_id="granite-3-2b",
    family=FAMILY_DENSE,
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    tie_embeddings=True,
    rope_theta=10_000.0,
)
