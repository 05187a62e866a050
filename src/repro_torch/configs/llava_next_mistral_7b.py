"""llava-next-mistral-7b [vlm] — mistral-7B backbone: 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000.  The anyres tiling vision tower is a
STUB: input_specs() provides precomputed CLIP patch embeddings
(d_frontend=1024, up to 2880 anyres tokens); the 2-layer projector and the
backbone are real.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from ..models.config import FAMILY_VLM, ModelConfig

CONFIG = ModelConfig(
    arch_id="llava-next-mistral-7b",
    family=FAMILY_VLM,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    frontend_tokens=2880,    # anyres: 5 tiles x 576 patches
    d_frontend=1024,
    rope_theta=1_000_000.0,
)
