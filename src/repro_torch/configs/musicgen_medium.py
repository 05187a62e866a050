"""musicgen-medium [audio] — 48L d_model=1536 24H (MHA kv=24) d_ff=6144
vocab=2048; decoder-only over EnCodec tokens.  The EnCodec frontend is a
STUB: input_specs() provides precomputed frame embeddings (d_frontend=128,
the EnCodec latent width); the in-model projection + backbone are real.
[arXiv:2306.05284]"""
from ..models.config import FAMILY_AUDIO, ModelConfig

CONFIG = ModelConfig(
    arch_id="musicgen-medium",
    family=FAMILY_AUDIO,
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,              # EnCodec codebook size
    d_frontend=128,
    rope_theta=10_000.0,
)
