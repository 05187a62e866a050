"""Model configuration for every supported architecture family.

One ``ModelConfig`` describes a decoder-only backbone with per-family
extensions (MoE, xLSTM, RG-LRU hybrid, modality-frontend stubs).  The ten
assigned architectures instantiate these in ``repro_torch.configs.<id>``.
A copy of the JAX package's module, logic unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILY_DENSE = "dense"
FAMILY_MOE = "moe"
FAMILY_AUDIO = "audio"     # decoder-only over codec tokens; frontend stub
FAMILY_VLM = "vlm"         # text backbone + patch-embedding stub
FAMILY_SSM = "ssm"         # xLSTM (sLSTM + mLSTM blocks)
FAMILY_HYBRID = "hybrid"   # RG-LRU + local attention (RecurrentGemma)

# per-block kinds (the layer stack is a repeating pattern of these)
BLOCK_ATTN = "attn"            # global causal attention + FFN
BLOCK_LOCAL_ATTN = "local"     # sliding-window attention + FFN
BLOCK_RECURRENT = "rglru"      # RG-LRU recurrent block + FFN
BLOCK_MLSTM = "mlstm"          # xLSTM mLSTM block (self-contained)
BLOCK_SLSTM = "slstm"          # xLSTM sLSTM block (self-contained)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0                  # per-expert FFN width
    first_dense_layers: int = 0           # leading dense layers (DeepSeek)
    dense_d_ff: int = 0                   # FFN width of those dense layers
    capacity_factor: float = 1.25
    # --- hybrid / recurrent ---
    block_pattern: Tuple[str, ...] = ()   # repeating pattern; () -> all attn
    local_window: int = 2048              # sliding-window size for BLOCK_LOCAL_ATTN
    mlstm_chunk: int = 0                  # 0 = exact sequential scan;
                                          # T>0 = exact chunkwise-parallel (§Perf-A)
    lru_width: int = 0                    # RG-LRU state width (0 -> d_model)
    conv1d_width: int = 4                 # temporal conv in recurrent blocks
    # --- modality frontend stubs ---
    frontend_tokens: int = 0              # image/audio positions provided as
                                          # precomputed embeddings by input_specs()
    d_frontend: int = 0                   # width of precomputed frontend embeds
    # --- numerics ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    def frontend_dim(self) -> int:
        """Width of the precomputed frontend embeddings (stub input)."""
        if self.d_frontend:
            return self.d_frontend
        return {FAMILY_AUDIO: 128, FAMILY_VLM: 1024}.get(self.family, 0)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def block_kind(self, layer: int) -> str:
        if self.block_pattern:
            return self.block_pattern[layer % len(self.block_pattern)]
        return BLOCK_ATTN

    @property
    def attention_free(self) -> bool:
        """True when no block uses global attention (sub-quadratic models)."""
        kinds = {self.block_kind(i) for i in range(self.n_layers)}
        return BLOCK_ATTN not in kinds

    def n_params(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.hd
        H, Hkv = self.n_heads, self.n_kv_heads
        total = self.vocab * d                      # embedding
        if not self.tie_embeddings:
            total += d * self.vocab                 # lm head
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
                qkv = d * H * hd + 2 * d * Hkv * hd + H * hd * d
                if self.qkv_bias:
                    qkv += (H + 2 * Hkv) * hd
                total += qkv
                total += self._ffn_params(i)
                total += 2 * d                      # norms
            elif kind == BLOCK_RECURRENT:
                w = self.lru_width or d
                total += d * w * 2 + w * d + 2 * w  # in/gate proj, out, lru params
                total += self.conv1d_width * w
                total += self._ffn_params(i) + 2 * d
            elif kind == BLOCK_MLSTM:
                # up-proj x2 (gate), qkv projections in up space, down-proj
                up = 2 * d
                total += d * up * 2 + up * d + 3 * up * up // 4 + 3 * up + d
            elif kind == BLOCK_SLSTM:
                total += 4 * d * d + 4 * d * d + 8 * d + d  # i,f,z,o recurrent
        total += d                                  # final norm
        return total

    def n_active_params(self) -> int:
        """Params touched per token (= total for dense; routed subset for MoE)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        # subtract inactive routed experts
        per_expert = 3 * d * self.expert_d_ff
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = (self.n_experts - self.top_k) * per_expert * n_moe_layers
        return total - inactive

    def _ffn_params(self, layer: int) -> int:
        d = self.d_model
        if self.is_moe and layer >= self.first_dense_layers:
            routed = self.n_experts * 3 * d * self.expert_d_ff
            shared = self.n_shared_experts * 3 * d * self.expert_d_ff
            router = d * self.n_experts
            return routed + shared + router
        ff = self.dense_d_ff if (self.is_moe and self.dense_d_ff) else self.d_ff
        if ff == 0:
            return 0
        return 3 * d * ff  # SwiGLU: gate + up + down
