"""Serving: prefill + single-token decode against persistent caches.

The JAX package's ``serving/decode.py`` in PyTorch.  Cache kinds per block:
  attn   : full KV cache [B, Smax, Hkv, hd] (RoPE applied at write time)
  local  : ring KV cache [B, W, Hkv, hd], W = min(local_window, Smax)
           (RoPE at write)
  rglru  : {h [B,w] f32, conv [B,cw-1,w]}
  mlstm  : {C [B,H,hk,hv] f32, n, m, conv}
  slstm  : {c, n, m, h [B,H,hd] f32}

The caches are a list in layer order (the reference stacks the body's
across periods for ``lax.scan``); each layer's cache is a dict with the
reference's leaf names and dtypes.  ``decode_step`` writes the new token's
keys and values into the KV caches in place, replaces the recurrent
states, and returns the same list.  A write at ``pos >= Smax`` raises (the
reference's ``dynamic_update_slice`` clamps it to ``Smax - 1``), and so
does a write at ``pos >= W`` into a ring shorter than the window (the
reference wraps it onto a position still inside the window): grow the
caches first (``grow_caches``, which also widens a ring shorter than the
window, so that decoding past the prompt evicts no position still inside
it).

Over a mesh's ``model`` axis (``tp``, a ``distributed.tp.ModelAxis``) the
blocks hold this rank's heads, widths and vocab rows, and the caches go in
and come out for the local batch: a recurrent state as its block's
weights are cut (this rank's lru width, mLSTM up width or sLSTM heads),
a KV cache with all kv heads and all positions or this rank's block of S
(``tp.seq_len`` gives the full length, so that the decode step knows
which positions it holds): the step then attends with all q heads over
its positions and combines the ranks' partial softmax (flash-decode).
``distributed.tp`` lays the caches out per ``cache_shardings``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..models import rglru as rg
from ..models import xlstm as xl
from ..models.config import (BLOCK_ATTN, BLOCK_LOCAL_ATTN, BLOCK_MLSTM, BLOCK_RECURRENT,
                             BLOCK_SLSTM, FAMILY_AUDIO, ModelConfig)
from ..models.layers import (WHOLE, apply_rope, einsum, flash_attention, local_attention,
                             rms_norm)
from ..models.transformer import (Model, _apply_ffn, _dtype, _qkv, attn_out, embed_inputs,
                                  embed_tokens, heads_cut, kv_for_heads, layer_is_moe,
                                  rglru_ffn, unembed)

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------

def _block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int, dev) -> Cache:
    dt = _dtype(cfg.compute_dtype)
    f32 = torch.float32
    Hkv, hd, H = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
    if kind == BLOCK_ATTN:
        return {"k": z((batch, s_max, Hkv, hd), dt), "v": z((batch, s_max, Hkv, hd), dt)}
    if kind == BLOCK_LOCAL_ATTN:
        W = min(cfg.local_window, s_max)
        return {"k": z((batch, W, Hkv, hd), dt), "v": z((batch, W, Hkv, hd), dt)}
    if kind == BLOCK_RECURRENT:
        w = cfg.lru_width or cfg.d_model
        return {"h": z((batch, w), f32), "conv": z((batch, cfg.conv1d_width - 1, w), dt)}
    if kind == BLOCK_MLSTM:
        up = 2 * cfg.d_model
        hdm = up // H
        return {"C": z((batch, H, hdm, hdm), f32), "n": z((batch, H, hdm), f32),
                "m": torch.full((batch, H), -math.inf, dtype=f32, device=dev),
                "conv": z((batch, cfg.conv1d_width - 1, up), dt)}
    if kind == BLOCK_SLSTM:
        hds = cfg.d_model // H
        return {"c": z((batch, H, hds), f32), "n": z((batch, H, hds), f32),
                "m": torch.full((batch, H, hds), -math.inf, dtype=f32, device=dev),
                "h": z((batch, H, hds), f32)}
    raise ValueError(kind)


def _caches(cfg: ModelConfig, batch: int, s_max: int, dev) -> List[Cache]:
    return [_block_cache(cfg, cfg.block_kind(i), batch, s_max, dev)
            for i in range(cfg.n_layers)]


def init_caches(cfg: ModelConfig, batch: int, s_max: int, *,
                device=None) -> List[Cache]:
    """Empty caches for ``batch`` sequences of up to ``s_max`` positions.
    ``device=None`` means the card (raises without one)."""
    from ..core.engine import resolve_device
    return _caches(cfg, batch, s_max, resolve_device(device))


def abstract_caches(cfg: ModelConfig, batch: int, s_max: int) -> List[Cache]:
    """The same caches on the ``meta`` device: shapes and dtypes only."""
    return _caches(cfg, batch, s_max, torch.device("meta"))


def grow_caches(cfg: ModelConfig, caches: List[Cache], extra: int) -> List[Cache]:
    """The caches made ready for ``extra`` more positions, so that decoding
    can go on past the prefill's length: each full-attention KV cache
    padded by ``extra`` zero positions (new tensors), each local ring of n
    slots padded with zero slots to min(local_window, n + extra).  A ring
    shorter than the window holds position p at slot p, so the padding
    keeps slot = pos mod W; a ring of window slots is kept, and so are the
    recurrent states.  This is ``distributed.tp.make_prefill``'s layout at
    ``s_max`` = S + ``extra``."""
    out = []
    for i, c in enumerate(caches):
        kind = cfg.block_kind(i)
        pad = 0
        if kind == BLOCK_ATTN:
            pad = extra
        elif kind == BLOCK_LOCAL_ATTN:
            n = c["k"].shape[1]
            pad = min(cfg.local_window, n + extra) - n
        if kind == BLOCK_ATTN or pad:
            c = {name: torch.cat([t, t.new_zeros((t.shape[0], pad) + t.shape[2:])],
                                 dim=1) for name, t in c.items()}
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# Single-token block application
# ---------------------------------------------------------------------------

def _whole_heads(cfg: ModelConfig, tp, k, v):
    """k/v [B,S,Hkv_local,hd] -> all ``n_kv_heads`` (a cache's layout)."""
    if tp.cut(k.shape[2], cfg.n_kv_heads):
        return tp.gather(k, 2), tp.gather(v, 2)
    return k, v


def _attend(p, cfg: ModelConfig, x, q, kc, vc, valid, layer_is_moe, tp=WHOLE,
            moe_fn=None, seq_cut: bool = False):
    """Attention of the one-token q (this rank's heads) over the cache
    rows ``valid``, then the output projection and the FFN.  With
    ``seq_cut`` the caches hold this rank's positions only: every rank
    attends with all q heads, the partial max, sum and numerator are
    combined over the ranks, and each keeps its own heads."""
    B, hd = x.shape[0], cfg.hd
    Hl = q.shape[2]
    if seq_cut:
        qa = tp.gather(q, 2) if heads_cut(p, cfg, tp) else q        # [B,1,H,hd]
        Hkv = kc.shape[2]
        qg = qa.reshape(B, Hkv, cfg.n_heads // Hkv, hd)
        s = torch.einsum("bhgd,bshd->bhgs", qg.float(), kc.float()) / math.sqrt(hd)
        s = torch.where(valid[None, None, None, :], s, -math.inf)
        # a rank holding no valid position has an all -inf row: weight 0
        m = tp.max(s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m), m, 0.0)
        pr = torch.where(valid[None, None, None, :], torch.exp(s - m_safe[..., None]), 0.0)
        den = tp.reduce(pr.sum(dim=-1))
        num = tp.reduce(torch.einsum("bhgs,bshd->bhgd", pr, vc.float()))
        attn = (num / torch.clamp_min(den[..., None], 1e-30)).reshape(B, 1, cfg.n_heads, hd)
        attn = attn.narrow(2, tp.offset(cfg.n_heads) if Hl != cfg.n_heads else 0, Hl)
    else:
        kc, vc = kv_for_heads(cfg, tp, Hl, kc, vc)
        Hkv = kc.shape[2]
        qg = q.reshape(B, Hkv, Hl // Hkv, hd)
        s = torch.einsum("bhgd,bshd->bhgs", qg.float(), kc.float()) / math.sqrt(hd)
        s = torch.where(valid[None, None, None, :], s, -math.inf)
        pr = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhgs,bshd->bhgd", pr, vc.float()).reshape(B, 1, Hl, hd)
    x = x + attn_out(p, cfg, attn.to(x.dtype), tp)
    h2 = rms_norm(tp.enter(x), p.ln2, cfg.norm_eps)
    y, _ = _apply_ffn(p.ffn, cfg, h2, layer_is_moe, moe_fn, tp)
    return x + y


def _rope_qkv(p, cfg: ModelConfig, x, pos: int, tp=WHOLE):
    B = x.shape[0]
    h = rms_norm(tp.enter(x), p.ln1, cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, tp)                   # [B,1,H,hd]/[B,1,Hkv,hd]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    return apply_rope(q, posv, cfg.rope_theta), apply_rope(k, posv, cfg.rope_theta), v


def _seq_block(tp, n_local: int, n_full: int):
    """(whether the cache holds a block of its ``n_full`` positions, where
    that block starts)."""
    cut = tp.cut(n_local, n_full)
    return cut, tp.offset(n_full) if cut else 0


def _write(cache, row: int, lo: int, k, v) -> None:
    """The new token's k/v (all kv heads) at cache row ``row``, on the rank
    whose block [lo, lo + n) holds it."""
    if lo <= row < lo + cache["k"].shape[1]:
        cache["k"][:, row - lo] = k[:, 0].to(cache["k"].dtype)
        cache["v"][:, row - lo] = v[:, 0].to(cache["v"].dtype)


def _decode_full_attn(p, cfg: ModelConfig, x, cache, pos: int, layer_is_moe, tp=WHOLE,
                      moe_fn=None):
    """x [B,1,d]; full-cache attention at absolute position ``pos``."""
    n = cache["k"].shape[1]
    S = tp.seq_len or n
    if not 0 <= pos < S:
        raise IndexError(f"decode at position {pos} past the KV cache's "
                         f"{S} positions; grow the caches first")
    cut, lo = _seq_block(tp, n, S)
    q, k, v = _rope_qkv(p, cfg, x, pos, tp)
    _write(cache, pos, lo, *_whole_heads(cfg, tp, k, v))
    valid = torch.arange(lo, lo + n, device=x.device) <= pos
    return _attend(p, cfg, x, q, cache["k"], cache["v"], valid, layer_is_moe, tp, moe_fn,
                   cut), cache


def _decode_local_attn(p, cfg: ModelConfig, x, cache, pos: int, layer_is_moe, tp=WHOLE,
                       moe_fn=None):
    """Ring-cache sliding-window attention (slot = pos mod W)."""
    n = cache["k"].shape[1]
    W = min(cfg.local_window, tp.seq_len) if tp.seq_len else n
    if W < cfg.local_window and pos >= W:
        # a ring shorter than the window would wrap onto positions that
        # are still inside it
        raise IndexError(f"decode at position {pos} past the ring cache's "
                         f"{W} slots (window {cfg.local_window}); grow the caches first")
    cut, lo = _seq_block(tp, n, W)
    q, k, v = _rope_qkv(p, cfg, x, pos, tp)
    slot = pos % W
    _write(cache, slot, lo, *_whole_heads(cfg, tp, k, v))
    # absolute position stored in ring slot j
    j = torch.arange(lo, lo + n, device=x.device)
    base = pos - slot
    abs_pos = torch.where(j <= slot, base + j, base - W + j)
    valid = (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - cfg.local_window)
    return _attend(p, cfg, x, q, cache["k"], cache["v"], valid, layer_is_moe, tp, moe_fn,
                   cut), cache


def _decode_rglru(p, cfg: ModelConfig, x, cache, tp=WHOLE):
    y, st = rg.rglru_apply(p, x, {"h": cache["h"], "conv": cache["conv"]}, tp=tp)
    cache.update(h=st["h"], conv=st["conv"].to(cache["conv"].dtype))
    return rglru_ffn(p, cfg, y, tp), cache


def decode_block(p, cfg: ModelConfig, kind: str, x, cache: Cache, pos: int,
                 layer_is_moe: bool, tp=WHOLE, moe_fn=None):
    if kind == BLOCK_ATTN:
        return _decode_full_attn(p, cfg, x, cache, pos, layer_is_moe, tp, moe_fn)
    if kind == BLOCK_LOCAL_ATTN:
        return _decode_local_attn(p, cfg, x, cache, pos, layer_is_moe, tp, moe_fn)
    if kind == BLOCK_RECURRENT:
        return _decode_rglru(p, cfg, x, cache, tp)
    if kind == BLOCK_MLSTM:
        y, ns = xl.mlstm_apply(p, x, cache, n_heads=cfg.n_heads, tp=tp)
        cache.update(C=ns["C"], n=ns["n"], m=ns["m"], conv=ns["conv"].to(cache["conv"].dtype))
        return y, cache
    if kind == BLOCK_SLSTM:
        y, ns = xl.slstm_apply(p, x, cache, n_heads=cfg.n_heads, tp=tp)
        cache.update(ns)
        return y, cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# decode_step: one new token against seq_len caches
# ---------------------------------------------------------------------------

def decode_step(params: Model, cfg: ModelConfig, caches: List[Cache],
                inputs: Dict[str, torch.Tensor], pos: int, *, tp=WHOLE,
                moe_fn=None) -> Tuple[torch.Tensor, List[Cache]]:
    """inputs: {"token": [B] int32} (or {"frame_embeds": [B, d_frontend]} for
    the audio family); ``pos`` the new token's position.  Returns (logits
    [B, vocab] f32, the caches, updated in place).  ``tp`` and ``moe_fn``
    as in ``forward`` (the logits are this rank's vocab block where the
    vocab is cut)."""
    dt = _dtype(cfg.compute_dtype)
    pos = int(pos)
    if cfg.family == FAMILY_AUDIO:
        x = tp.exit_whole(inputs["frame_embeds"][:, None, :].to(dt) @ params.in_proj.to(dt))
    else:
        x = embed_tokens(params, cfg, inputs["token"][:, None], tp)
    for li, p in enumerate(params.layers):
        x, caches[li] = decode_block(p, cfg, cfg.block_kind(li), x, caches[li],
                                     pos, layer_is_moe(cfg, li), tp, moe_fn)
    return unembed(params, cfg, x, tp)[:, 0], caches


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also fills the caches
# ---------------------------------------------------------------------------

def _prefill_attn(p, cfg, x, positions, *, local: bool, layer_is_moe: bool,
                  q_chunk: int, moe_fn=None, tp=WHOLE):
    h = rms_norm(tp.enter(x), p.ln1, cfg.norm_eps)
    q, k, v = _qkv(p, cfg, h, tp)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    kq, vq = kv_for_heads(cfg, tp, q.shape[2], k, v)
    k, v = _whole_heads(cfg, tp, k, v)
    S = x.shape[1]
    qc = min(q_chunk, S)
    if local:
        attn = local_attention(q, kq, vq, window=cfg.local_window, q_chunk=qc)
        W = min(cfg.local_window, S)
        # the last W positions, rolled so that slot = pos mod W
        shift = (S - W) % W
        cache = {"k": torch.roll(k[:, S - W:], shift, dims=1),
                 "v": torch.roll(v[:, S - W:], shift, dims=1)}
    else:
        attn = flash_attention(q, kq, vq, causal=True, q_chunk=qc, kv_chunk=qc)
        cache = {"k": k, "v": v}
    x = x + attn_out(p, cfg, attn, tp)
    h2 = rms_norm(tp.enter(x), p.ln2, cfg.norm_eps)
    y, _ = _apply_ffn(p.ffn, cfg, h2, layer_is_moe, moe_fn, tp)
    return x + y, cache


def prefill_block(p, cfg: ModelConfig, kind: str, x, positions,
                  layer_is_moe: bool, q_chunk: int = 512, moe_fn=None, tp=WHOLE):
    if kind in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
        return _prefill_attn(p, cfg, x, positions, local=(kind == BLOCK_LOCAL_ATTN),
                             layer_is_moe=layer_is_moe, q_chunk=q_chunk, moe_fn=moe_fn,
                             tp=tp)
    dt = _dtype(cfg.compute_dtype)
    if kind == BLOCK_RECURRENT:
        y, st = rg.rglru_apply(p, x, tp=tp)
        return rglru_ffn(p, cfg, y, tp), {"h": st["h"], "conv": st["conv"].to(dt)}
    if kind == BLOCK_MLSTM:
        y, st = xl.mlstm_apply(p, x, n_heads=cfg.n_heads, chunk=cfg.mlstm_chunk, tp=tp)
        st["conv"] = st["conv"].to(dt)
        return y, st
    if kind == BLOCK_SLSTM:
        return xl.slstm_apply(p, x, n_heads=cfg.n_heads, tp=tp)
    raise ValueError(kind)


def prefill(params: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor], *,
            q_chunk: int = 512, act_shard=None, moe_fn=None,
            tp=WHOLE) -> Tuple[torch.Tensor, List[Cache]]:
    """Returns (last-position logits [B, vocab] f32, caches sized S).
    ``act_shard``, ``moe_fn`` and ``tp`` are ``forward``'s hooks; under
    ``tp`` the caches come out for the batch given, laid out as
    ``decode_step`` takes them (whole S)."""
    constrain = act_shard if act_shard is not None else (lambda t: t)
    x = embed_inputs(params, cfg, batch, tp)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    caches = []
    for li, p in enumerate(params.layers):
        x, c = prefill_block(p, cfg, cfg.block_kind(li), x, positions,
                             layer_is_moe(cfg, li), q_chunk=q_chunk, moe_fn=moe_fn, tp=tp)
        x = constrain(x)
        caches.append(c)
    return unembed(params, cfg, x[:, -1:], tp)[:, 0], caches
