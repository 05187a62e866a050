"""Unified decoder-only model covering all ten assigned architectures.

The JAX package's ``models/transformer.py`` in PyTorch.  The layer stack
is a repeating ``block_pattern`` over {attn, local, rglru, mlstm, slstm}.
The reference stacks the body's parameters across pattern periods for
``lax.scan``; here ``Model.layers`` is one ``nn.ModuleList`` in layer
order (the head's ``first_dense_layers``, then the body periods, then the
tail; ``stack_segments`` names them), and ``forward`` walks it.

Every block is a module whose parameters keep the reference's leaf names,
layouts and dtypes (``wq`` [d, H, hd], ``wo`` [H, hd, d], ``e_gate``
[E, d, f], norm scales as a delta from 1), so ``repro_torch.convert``
carries the reference's weights across with a copy.  Parameters do not
require grad unless a trainer asks (``train.step`` turns it on around its
backward).  ``forward``'s ``remat`` checkpoints each body period, as the
reference's ``jax.checkpoint(period_fn)`` does.  The mesh hooks have the
reference's meaning: ``act_shard`` and ``logit_shard`` are closures applied
to each layer's activations and to the logits (``launch.sharding``'s
``act_constraint`` / ``logit_constraint``), and ``moe_fn(p, x)`` replaces
the routed experts (``layers.make_tp_moe_fn``; the shared experts stay
dense).

Modality frontends (audio frames / VLM patches) are stubs: the model gets
precomputed frame/patch embeddings; the in-model projection and the
embedding merge are real.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import (BLOCK_ATTN, BLOCK_LOCAL_ATTN, BLOCK_MLSTM,
                     BLOCK_RECURRENT, BLOCK_SLSTM, FAMILY_AUDIO, FAMILY_VLM,
                     ModelConfig)
from .layers import (WHOLE, Leaves, apply_rope, dense, einsum, flash_attention,
                     flash_attention_cv, gelu, local_attention, moe_ffn, rms_norm,
                     swiglu, zeros)
from . import rglru as rg
from . import xlstm as xl


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Layer segments: head / body periods / tail
# ---------------------------------------------------------------------------

def stack_segments(cfg: ModelConfig) -> Tuple[List[int], List[List[int]], List[int]]:
    """Layer indices of (head, body-periods, tail)."""
    head = list(range(cfg.first_dense_layers))
    rest = list(range(cfg.first_dense_layers, cfg.n_layers))
    period = len(cfg.block_pattern) if cfg.block_pattern else 1
    n_periods = len(rest) // period
    body = [rest[i * period:(i + 1) * period] for i in range(n_periods)]
    tail = rest[n_periods * period:]
    return head, body, tail


def layer_is_moe(cfg: ModelConfig, layer: int) -> bool:
    return cfg.is_moe and layer >= cfg.first_dense_layers


# ---------------------------------------------------------------------------
# Blocks (the reference's init_* leaves)
# ---------------------------------------------------------------------------

class FFN(Leaves):
    """SwiGLU FFN: ``w_gate``, ``w_up`` [d, ff], ``w_down`` [ff, d]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, _dtype(cfg.param_dtype)
        ff = cfg.dense_d_ff if (cfg.is_moe and cfg.dense_d_ff) else cfg.d_ff
        self.leaf("w_gate", (d, ff), dt, dense(), device)
        self.leaf("w_up", (d, ff), dt, dense(), device)
        self.leaf("w_down", (ff, d), dt, dense(1.0 / ff ** 0.5), device)


class MoEFFN(Leaves):
    """Routed experts (``router`` [d, E], ``e_*``) and the optional shared
    experts (``s_*``, one SwiGLU of width n_shared * f)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, _dtype(cfg.param_dtype)
        E, f = cfg.n_experts, cfg.expert_d_ff
        self.leaf("router", (d, E), torch.float32, dense(), device)
        self.leaf("e_gate", (E, d, f), dt, dense(), device)
        self.leaf("e_up", (E, d, f), dt, dense(), device)
        self.leaf("e_down", (E, f, d), dt, dense(1.0 / f ** 0.5), device)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * f
            self.leaf("s_gate", (d, fs), dt, dense(), device)
            self.leaf("s_up", (d, fs), dt, dense(), device)
            self.leaf("s_down", (fs, d), dt, dense(1.0 / fs ** 0.5), device)


def make_ffn(cfg: ModelConfig, layer: int, device=None) -> Leaves:
    return MoEFFN(cfg, device) if layer_is_moe(cfg, layer) else FFN(cfg, device)


class AttnBlock(Leaves):
    """Global or local attention + FFN (the reference's ``init_attn_block``;
    the local window is ``cfg.local_window``)."""

    def __init__(self, cfg: ModelConfig, layer: int, device=None):
        super().__init__()
        d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        dt, f32 = _dtype(cfg.param_dtype), torch.float32
        self.leaf("ln1", (d,), f32, zeros, device)
        self.leaf("wq", (d, H, hd), dt, dense(), device)
        self.leaf("wk", (d, Hkv, hd), dt, dense(), device)
        self.leaf("wv", (d, Hkv, hd), dt, dense(), device)
        self.leaf("wo", (H, hd, d), dt, dense(1.0 / (H * hd) ** 0.5), device)
        self.leaf("ln2", (d,), f32, zeros, device)
        if cfg.qkv_bias:
            self.leaf("bq", (H, hd), f32, zeros, device)
            self.leaf("bk", (Hkv, hd), f32, zeros, device)
            self.leaf("bv", (Hkv, hd), f32, zeros, device)
        if cfg.qk_norm:
            self.leaf("q_norm", (hd,), f32, zeros, device)
            self.leaf("k_norm", (hd,), f32, zeros, device)
        self.ffn = make_ffn(cfg, layer, device)


class RGLRUBlock(Leaves):
    """RG-LRU leaves (``rglru.rglru_leaves``) + an always-dense FFN."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        rg.rglru_leaves(self, d, cfg.lru_width or d, cfg.conv1d_width,
                        _dtype(cfg.param_dtype), device)
        if cfg.d_ff:
            self.ffn = FFN(cfg, device)
            self.leaf("ln2", (d,), torch.float32, zeros, device)


def make_block(cfg: ModelConfig, layer: int, device=None) -> Leaves:
    kind = cfg.block_kind(layer)
    dt = _dtype(cfg.param_dtype)
    if kind in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
        return AttnBlock(cfg, layer, device)
    if kind == BLOCK_RECURRENT:
        return RGLRUBlock(cfg, device)
    if kind == BLOCK_MLSTM:
        return xl.MLSTMBlock(cfg.d_model, cfg.n_heads, cfg.conv1d_width, dt, device)
    if kind == BLOCK_SLSTM:
        return xl.SLSTMBlock(cfg.d_model, cfg.n_heads, dt, device)
    raise ValueError(kind)


class Model(Leaves):
    """Embedding (``embed`` [vocab, d], or the audio family's ``in_proj``
    [d_frame, d]), the VLM projector, ``layers`` in layer order,
    ``final_norm`` and an untied ``lm_head`` [d, vocab]."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, dt = cfg.d_model, _dtype(cfg.param_dtype)
        if cfg.family == FAMILY_AUDIO:
            # EnCodec frame embeddings arrive precomputed (stub); in-model proj
            self.leaf("in_proj", (cfg.frontend_dim(), d), dt, dense(), device)
        else:
            self.leaf("embed", (cfg.vocab, d), dt, dense(0.02), device)
        if cfg.family == FAMILY_VLM:
            self.leaf("img_proj_w1", (cfg.frontend_dim(), d), dt, dense(), device)
            self.leaf("img_proj_w2", (d, d), dt, dense(), device)
        self.layers = nn.ModuleList(make_block(cfg, i, device)
                                    for i in range(cfg.n_layers))
        self.leaf("final_norm", (d,), torch.float32, zeros, device)
        if not cfg.tie_embeddings:
            self.leaf("lm_head", (d, cfg.vocab), dt, dense(0.02), device)


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> Model:
    """A model with the reference's distributions and scales, drawn from one
    ``torch.Generator`` seeded with ``seed`` on the device.  ``device=None``
    means the card (raises without one).  The values are not the
    reference's (it draws from ``jax.random``); parity runs on weights
    carried across by ``repro_torch.convert``.  The reference draws
    ``img_proj_w1`` and ``lm_head`` from one shared key; here every leaf
    has its own draws."""
    from ..core.engine import resolve_device
    dev = resolve_device(device)
    model = Model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Leaves):
            m.reset_parameters(gen)
    return model


def abstract_params(cfg: ModelConfig) -> Model:
    """The same model on the ``meta`` device: shapes and dtypes, no storage."""
    return Model(cfg, torch.device("meta"))


# ---------------------------------------------------------------------------
# Block application (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------

def heads_cut(p, cfg: ModelConfig, tp=WHOLE) -> bool:
    """Whether the block holds this rank's query heads only."""
    return tp.cut(p.wq.shape[1], cfg.n_heads)


def _qkv(p, cfg: ModelConfig, x, tp=WHOLE):
    """x [B,S,d] (replicated) -> q [B,S,H,hd], k/v [B,S,Hkv,hd] with
    bias/qk-norm.  With the heads cut, q holds this rank's heads and k/v
    this rank's kv heads, or all of them where ``kv_heads`` is replicated
    (``kv_for_heads`` then picks the ones the local q heads read)."""
    wk, wv, bk, bv = p.wk, p.wv, p.bk if cfg.qkv_bias else None, \
        p.bv if cfg.qkv_bias else None
    q_norm = k_norm = None
    if cfg.qk_norm:
        q_norm, k_norm = p.q_norm, p.k_norm
    if heads_cut(p, cfg, tp):
        x = tp.cols(x)
        # replicated leaves each rank uses for its own heads only
        part = lambda w: None if w is None else tp.part(w)
        if not tp.cut(wk.shape[1], cfg.n_kv_heads):
            wk, wv, bk, bv = part(wk), part(wv), part(bk), part(bv)
        q_norm, k_norm = part(q_norm), part(k_norm)
    q = einsum("bsd,dhk->bshk", x, p.wq)
    k = einsum("bsd,dhk->bshk", x, wk)
    v = einsum("bsd,dhk->bshk", x, wv)
    if cfg.qkv_bias:
        q = q + p.bq.to(q.dtype)
        k = k + bk.to(k.dtype)
        v = v + bv.to(v.dtype)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    return q, k, v


def kv_for_heads(cfg: ModelConfig, tp, n_local: int, k, v):
    """The kv heads this rank's ``n_local`` query heads read (GQA: q head
    h reads kv head h // (H / Hkv)), where k/v hold all ``n_kv_heads``
    and the q heads are cut: a contiguous range when the local heads
    cover whole groups or lie in one, else one kv head per q head."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if n_local == H or k.shape[2] != Hkv:
        return k, v
    G, lo = H // Hkv, tp.offset(H)
    if n_local % G == 0 or G % n_local == 0:
        first, n = lo // G, max(n_local // G, 1)
        return k[:, :, first:first + n], v[:, :, first:first + n]
    idx = torch.tensor([(lo + h) // G for h in range(n_local)], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _swiglu(x, w_gate, w_up, w_down, full: int, tp=WHOLE):
    """SwiGLU of a replicated x -> the residual stream's layout: column-
    then row-parallel where the ``full``-wide hidden dim is cut."""
    if tp.cut(w_gate.shape[-1], full):
        return tp.exit(swiglu(tp.cols(x), w_gate, w_up, w_down))
    return tp.exit_whole(swiglu(x, w_gate, w_up, w_down))


def _apply_ffn(p, cfg: ModelConfig, x, layer_is_moe: bool, moe_fn=None, tp=WHOLE):
    """x [B,S,d] (replicated) -> (y in the residual stream's layout,
    aux_loss).  ``moe_fn`` (optional) overrides the routed-expert
    implementation (e.g. ``layers.make_tp_moe_fn``); it takes and gives
    replicated tokens."""
    if layer_is_moe:
        B, S, d = x.shape
        if moe_fn is not None:
            y, aux = moe_fn(p, x)
        else:
            y, aux = moe_ffn(x.reshape(B * S, d), p.router, p.e_gate, p.e_up,
                             p.e_down, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
            y = y.reshape(B, S, d)
        y = tp.exit_whole(y)
        if cfg.n_shared_experts:
            y = y + _swiglu(x, p.s_gate, p.s_up, p.s_down,
                            cfg.n_shared_experts * cfg.expert_d_ff, tp)
        return y, aux
    ff = cfg.dense_d_ff if (cfg.is_moe and cfg.dense_d_ff) else cfg.d_ff
    return _swiglu(x, p.w_gate, p.w_up, p.w_down, ff, tp), _zero(x)


def _zero(x) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def attn_out(p, cfg: ModelConfig, attn, tp=WHOLE):
    """The output projection of attention over the block's q heads -> the
    residual stream's layout (row-parallel where the heads are cut)."""
    o = einsum("bshk,hkd->bsd", attn, p.wo)
    return tp.exit(o) if heads_cut(p, cfg, tp) else tp.exit_whole(o)


def apply_attn_block(p, cfg: ModelConfig, x, positions, *, local: bool,
                     layer_is_moe: bool, q_chunk: int = 512,
                     kv_chunk: int = 512, causal_skip: bool = False,
                     moe_fn=None, attn_remat: bool = False, flash_cv: bool = False,
                     tp=WHOLE):
    h = rms_norm(tp.enter(x), p.ln1, cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k, v = kv_for_heads(cfg, tp, q.shape[2], k, v)
    S = x.shape[1]
    qc = min(q_chunk, S)
    kc = min(kv_chunk, S)
    if local:
        attn = local_attention(q, k, v, window=cfg.local_window, q_chunk=qc)
    elif flash_cv:
        attn = flash_attention_cv(q, k, v, qc, kc)
    else:
        attn = flash_attention(q, k, v, causal=True, q_chunk=qc, kv_chunk=kc,
                               causal_skip=causal_skip, remat_qchunk=attn_remat)
    x = x + attn_out(p, cfg, attn, tp)
    h2 = rms_norm(tp.enter(x), p.ln2, cfg.norm_eps)
    y, aux = _apply_ffn(p.ffn, cfg, h2, layer_is_moe, moe_fn, tp)
    return x + y, aux


def rglru_ffn(p, cfg: ModelConfig, y, tp=WHOLE):
    """The recurrent block's FFN on its RG-LRU output (residual layout)."""
    if cfg.d_ff:
        h2 = rms_norm(tp.enter(y), p.ln2, cfg.norm_eps)
        f, _aux = _apply_ffn(p.ffn, cfg, h2, False, tp=tp)
        y = y + f
    return y


def apply_block(p, cfg: ModelConfig, kind: str, x, positions, *,
                layer_is_moe: bool, q_chunk: int = 512, kv_chunk: int = 512,
                causal_skip: bool = False, moe_fn=None, attn_remat: bool = False,
                flash_cv: bool = False, tp=WHOLE):
    """Full-sequence application with no carried state."""
    if kind in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
        return apply_attn_block(p, cfg, x, positions,
                                local=(kind == BLOCK_LOCAL_ATTN),
                                layer_is_moe=layer_is_moe, q_chunk=q_chunk,
                                kv_chunk=kv_chunk, causal_skip=causal_skip,
                                moe_fn=moe_fn, attn_remat=attn_remat,
                                flash_cv=flash_cv, tp=tp)
    if kind == BLOCK_RECURRENT:
        y, _ = rg.rglru_apply(p, x, tp=tp)
        return rglru_ffn(p, cfg, y, tp), _zero(x)
    if kind == BLOCK_MLSTM:
        y, _ = xl.mlstm_apply(p, x, n_heads=cfg.n_heads, chunk=cfg.mlstm_chunk, tp=tp)
        return y, _zero(x)
    if kind == BLOCK_SLSTM:
        y, _ = xl.slstm_apply(p, x, n_heads=cfg.n_heads,
                              remat_chunk=cfg.mlstm_chunk, tp=tp)
        return y, _zero(x)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Full forward (scoring)
# ---------------------------------------------------------------------------

def embed_tokens(params: Model, cfg: ModelConfig, tokens, tp=WHOLE):
    """Token ids -> embeddings in the compute dtype, in the residual
    stream's layout.  With the vocab cut, each rank looks up the ids its
    rows hold, zero for the others, and the ranks' rows are summed (one
    rank holds each id, so the sum is exact)."""
    dt = _dtype(cfg.compute_dtype)
    tokens = tokens.long()
    n = params.embed.shape[0]
    if not tp.cut(n, cfg.vocab):
        return tp.exit_whole(params.embed[tokens].to(dt))
    t = tokens - tp.offset(cfg.vocab)
    mine = (t >= 0) & (t < n)
    rows = params.embed[torch.where(mine, t, 0)]
    return tp.exit(torch.where(mine[..., None], rows, 0).to(dt))


def embed_inputs(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                 tp=WHOLE):
    """Token/frontend embedding -> [B,S,d] activations (the residual
    stream's layout)."""
    dt = _dtype(cfg.compute_dtype)
    if cfg.family == FAMILY_AUDIO:
        # precomputed EnCodec frame embeddings [B,S,d_frame] (frontend stub)
        return tp.exit_whole(batch["frame_embeds"].to(dt) @ params.in_proj.to(dt))
    x = embed_tokens(params, cfg, batch["tokens"], tp)
    if cfg.family == FAMILY_VLM and "image_embeds" in batch:
        # anyres patch embeddings [B,F,dv] (frontend stub) -> 2-layer projector
        img = batch["image_embeds"].to(dt)
        img = gelu(img @ params.img_proj_w1.to(dt))
        img = tp.exit_whole(img @ params.img_proj_w2.to(dt))
        F = img.shape[1]
        # image tokens occupy the first F positions (anyres prefix layout)
        x = torch.cat([img, x[:, F:]], dim=1)
    return x


def unembed(params: Model, cfg: ModelConfig, x, tp=WHOLE) -> torch.Tensor:
    """Final norm and the (tied or untied) output head; logits in float32,
    this rank's vocab block where the vocab is cut.  A head whose vocab is
    whole (a vocab-replicated tied table) over a model axis that divides
    it gives the logits' block too, from this rank's columns of it, as
    the reference's logit constraint reshards them."""
    x = rms_norm(tp.enter(x), params.final_norm, cfg.norm_eps)
    w_out = params.embed.T if cfg.tie_embeddings else params.lm_head
    V = w_out.shape[1]
    if tp.cut(V, cfg.vocab):
        x = tp.cols(x)
    elif tp.size > 1 and V % tp.size == 0:
        w_out = tp.split(w_out, 1)      # its backward gathers the columns' gradients
        x = tp.cols(x)
    return torch.einsum("bsd,dv->bsv", x, w_out.to(x.dtype)).float()


def forward(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            remat: bool = True, q_chunk: int = 512, kv_chunk: int = 512,
            causal_skip: bool = False, act_shard=None, logit_shard=None,
            moe_fn=None, attn_remat: bool = False,
            flash_cv: bool = False, tp=WHOLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits [B,S,vocab] f32, aux_loss scalar).

    ``remat``: each body period is checkpointed (its activations recomputed
    in the backward); the head and tail layers are not.  It acts only
    while autograd records, so serving under ``no_grad`` is unchanged.
    ``attn_remat`` checkpoints each attention query chunk; ``flash_cv``
    selects ``flash_attention_cv``.  The aux loss sums as the reference's
    does: per layer in the head and tail, per period in the body.
    ``act_shard`` is applied to every layer's output, ``logit_shard`` to
    the float32 logits, and ``moe_fn`` replaces each MoE layer's routed
    experts.  ``tp`` is the model axis (``distributed.tp.ModelAxis``) of
    a model whose leaves are this rank's blocks; the logits are then this
    rank's vocab block (all of it where the vocab is not cut)."""
    x = embed_inputs(params, cfg, batch, tp)
    B, S, d = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    head, body, tail = stack_segments(cfg)
    opts = dict(q_chunk=q_chunk, kv_chunk=kv_chunk, causal_skip=causal_skip,
                moe_fn=moe_fn, attn_remat=attn_remat, flash_cv=flash_cv, tp=tp)
    constrain = act_shard if act_shard is not None else (lambda t: t)

    def run(x, layers):
        """The layers in order: (x, their aux losses summed from 0)."""
        aux_sum = _zero(x)
        for li in layers:
            x, aux = apply_block(params.layers[li], cfg, cfg.block_kind(li), x,
                                 positions, layer_is_moe=layer_is_moe(cfg, li), **opts)
            x = constrain(x)
            aux_sum = aux_sum + aux
        return x, aux_sum

    aux_total = _zero(x)
    for li in head:
        x, aux = run(x, [li])
        aux_total = aux_total + aux
    period_ckpt = remat and torch.is_grad_enabled()
    for period in body:
        x, aux = (checkpoint(run, x, period, use_reentrant=False) if period_ckpt
                  else run(x, period))
        aux_total = aux_total + aux
    for li in tail:
        x, aux = run(x, [li])
        aux_total = aux_total + aux
    logits = unembed(params, cfg, x, tp)
    if logit_shard is not None:
        logits = logit_shard(logits)
    return logits, aux_total
