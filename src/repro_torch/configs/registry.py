"""Architecture registry: the ten assigned configs, the four input shapes,
reduced smoke-test variants, and the input specs of one (arch, shape)
cell as (shape, dtype) records (no allocation).

Each ``<arch>.py`` module in this package defines ``CONFIG``; this registry
imports them all (the port's own modules, by relative name) and owns the
shape logic.  ``get_config``, ``ShapeSpec``, ``SHAPES``,
``shape_applicable``, ``applicable_cells`` and ``reduced`` are copies of
the JAX package's; ``input_specs`` and ``concrete_batch`` give the same
names, shapes, dtypes and numpy draws as torch dtypes and tensors.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from ..models.config import FAMILY_AUDIO, FAMILY_VLM, ModelConfig

_ARCH_IDS = [
    "qwen1_5_110b",
    "qwen2_1_5b",
    "qwen3_4b",
    "granite_3_2b",
    "deepseek_moe_16b",
    "granite_moe_1b_a400m",
    "musicgen_medium",
    "llava_next_mistral_7b",
    "xlstm_125m",
    "recurrentgemma_9b",
]

# canonical dashed ids (CLI --arch) -> module names
ALIASES = {i.replace("_", "-"): i for i in _ARCH_IDS}


def _load() -> Dict[str, ModelConfig]:
    out = {}
    for mid in _ARCH_IDS:
        mod = importlib.import_module(f".{mid}", __package__)
        out[mid] = mod.CONFIG
    return out


ARCHS: Dict[str, ModelConfig] = _load()


def get_config(arch: str) -> ModelConfig:
    """Accepts module ids (qwen2_1_5b) and canonical ids (qwen2-1.5b)."""
    key = arch.replace("-", "_").replace(".", "_")
    return ARCHS[key]


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention state."""
    if shape.name == "long_500k" and not cfg.attention_free:
        return False, ("full-attention arch: a 500k dense KV cache is the "
                       "architecture's own limit; skipped per assignment")
    return True, ""


def applicable_cells() -> List[Tuple[str, str]]:
    cells = []
    for aid, cfg in ARCHS.items():
        for sname, sh in SHAPES.items():
            ok, _ = shape_applicable(cfg, sh)
            if ok:
                cells.append((aid, sname))
    return cells


# ---------------------------------------------------------------------------
# Reduced (smoke-test) configs — same family, tiny geometry
# ---------------------------------------------------------------------------

def reduced(cfg: ModelConfig) -> ModelConfig:
    """Family-preserving reduction for CPU smoke tests: keep the block
    pattern / MoE structure / frontends, shrink everything else."""
    period = max(1, len(cfg.block_pattern))
    n_layers = cfg.first_dense_layers + 2 * period + (1 if period > 1 else 0)
    H = min(cfg.n_heads, 4)
    Hkv = max(1, min(cfg.n_kv_heads, H))
    while H % Hkv:
        Hkv -= 1
    d = 64
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d,
        n_heads=H,
        n_kv_heads=Hkv,
        head_dim=(d // H) if cfg.head_dim is None else 32,
        d_ff=128 if cfg.d_ff else 0,
        vocab=128,
        n_experts=min(cfg.n_experts, 4),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        top_k=min(cfg.top_k, 2),
        expert_d_ff=32 if cfg.expert_d_ff else 0,
        dense_d_ff=96 if cfg.dense_d_ff else 0,
        # capacity >= E/top_k guarantees no token drops, so smoke tests can
        # compare train/prefill/decode paths exactly (full configs keep 1.25)
        capacity_factor=max(cfg.capacity_factor,
                            (min(cfg.n_experts, 4) / max(1, min(cfg.top_k, 2))) + 0.5)
        if cfg.n_experts else cfg.capacity_factor,
        local_window=32,
        lru_width=64 if cfg.lru_width else 0,
        frontend_tokens=min(cfg.frontend_tokens, 8),
        d_frontend=32 if cfg.family in (FAMILY_AUDIO, FAMILY_VLM) else 0,
        param_dtype="float32",
        compute_dtype="float32",
    )


# ---------------------------------------------------------------------------
# Input specs ((shape, dtype) records; nothing is allocated)
# ---------------------------------------------------------------------------

class TensorSpec(NamedTuple):
    """The port's stand-in for ``jax.ShapeDtypeStruct``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """Model-input stand-ins for one (arch, shape) cell.

    train   : full batch with labels (+frontend stubs)
    prefill : batch without labels
    decode  : one new token (+``pos``); caches are built separately
    """
    B, S = shape.batch, shape.seq
    f32, i32 = torch.float32, torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == FAMILY_AUDIO:
            batch = {"frame_embeds": TensorSpec((B, S, cfg.frontend_dim()), f32)}
        else:
            batch = {"tokens": TensorSpec((B, S), i32)}
            if cfg.family == FAMILY_VLM and cfg.frontend_tokens:
                F = min(cfg.frontend_tokens, S // 2)
                batch["image_embeds"] = TensorSpec((B, F, cfg.frontend_dim()), f32)
        if shape.kind == "train":
            batch["labels"] = TensorSpec((B, S), i32)
        return batch
    # decode: one token against a seq-S cache at position pos
    if cfg.family == FAMILY_AUDIO:
        inp = {"frame_embeds": TensorSpec((B, cfg.frontend_dim()), f32)}
    else:
        inp = {"token": TensorSpec((B,), i32)}
    return inp


def concrete_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0, *,
                   device=None) -> Dict[str, torch.Tensor]:
    """Real (small!) tensors matching input_specs, from the JAX package's
    numpy draws.  ``device=None`` means the card (raises without one)."""
    from ..core.engine import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in input_specs(cfg, shape).items():
        if s.dtype == torch.int32:
            a = rng.integers(0, max(2, cfg.vocab - 1), size=s.shape).astype(np.int32)
        else:
            a = rng.normal(size=s.shape).astype(np.float32)
        out[k] = torch.from_numpy(a).to(dev)
    return out
