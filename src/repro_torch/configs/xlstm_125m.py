"""xlstm-125m [ssm] — 12L d_model=768 4H vocab=50304; sLSTM + mLSTM blocks
(pattern m,m,m,s — one sLSTM per four blocks), d_ff=0 (blocks are
self-contained).  O(1) state -> runs the long_500k cell.
[arXiv:2405.04517]"""
from ..models.config import (BLOCK_MLSTM, BLOCK_SLSTM, FAMILY_SSM,
                             ModelConfig)

CONFIG = ModelConfig(
    arch_id="xlstm-125m",
    family=FAMILY_SSM,
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    tie_embeddings=True,
    block_pattern=(BLOCK_MLSTM, BLOCK_MLSTM, BLOCK_MLSTM, BLOCK_SLSTM),
)
