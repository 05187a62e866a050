"""Shared model layers: norms, RoPE, memory-efficient attention, FFN, MoE.

The JAX package's ``models/layers.py`` in PyTorch tensor ops, with the
same algorithms and numerics.  Attention is flash-style: a double loop
over query and key/value chunks with an online-softmax accumulator in
float32, so prefill holds one [Cq, Ck] score tile per head instead of an
S^2 tensor.  Local (sliding-window) attention slices only the banded keys
per query chunk.

The MoE layer uses the static-capacity sort-based dispatch: tokens are
sorted by expert (stably), gathered into an [E, C, d] buffer, run through
a batched per-expert SwiGLU, and combined with their gate weights.

``jnp`` promotes a product of two dtypes to the wider one and
``torch.matmul`` raises on it, so every product of two tensors goes
through ``matmul`` / ``einsum`` below, which promote as JAX does.

For training, ``flash_attention_cv`` is the reference's custom-VJP
attention as a ``torch.autograd.Function`` (a tiled backward that
recomputes each probability tile), and ``flash_attention``'s
``remat_qchunk`` checkpoints each query chunk.

``moe_ffn_tp`` is the expert-parallel MoE over a process group (the
``model`` axis of a ``launch.mesh`` mesh): each rank runs only its own
experts and one all-reduce combines them.  ``make_tp_moe_fn`` installs it
as ``forward``'s ``moe_fn``, where the reference's ``shard_map`` does.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

# (shape, generator, device) -> a float32 tensor of that shape
Init = Callable[[Sequence[int], torch.Generator, torch.device], torch.Tensor]


class Leaves(nn.Module):
    """A module whose parameters are the reference's leaves: each keeps its
    name, layout and dtype (``wq`` [d, H, hd], not ``nn.Linear``'s
    [out, in]), so carrying weights across is a copy.  Each leaf has its
    initializer; ``reset_parameters`` draws them all from one generator."""

    def __init__(self):
        super().__init__()
        self._inits: Dict[str, Init] = {}

    def leaf(self, name: str, shape: Sequence[int], dtype: torch.dtype,
             init: Init, device) -> None:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self._inits[name] = init

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name, init in self._inits.items():
            t = getattr(self, name)
            t.copy_(init(t.shape, gen, t.device))    # float32 -> leaf dtype


class Whole:
    """The ``model`` axis as the block code reads it, here for one process:
    every leaf is whole and every collective is the identity, so the block
    code runs the one-process math op for op.  ``distributed.tp.ModelAxis``
    is the same interface over a mesh's ``model`` group, where a leaf may
    be this rank's block (``cut``) and the collectives are ``comm``'s.

    A tensor is *replicated* (every rank holds it alike, with the same
    cotangent), *partial* (this rank's share of a sum) or this rank's
    *block* of a dim.  The residual stream is replicated, or under
    ``act`` (``tp_act``) this rank's block of d."""

    size, rank, act, seq_len = 1, 0, False, None

    def cut(self, local: int, full: int) -> bool:
        """Whether a dim of ``full`` entries is held as this rank's block."""
        return local != full

    def offset(self, full: int) -> int:
        """Where this rank's block of a dim of ``full`` entries starts."""
        return self.rank * (full // self.size)

    def cols(self, x):
        """A replicated input to a product with cut columns."""
        return x

    def part(self, w):
        """A replicated leaf of which each rank uses its own part: its
        gradient is summed over the ranks."""
        return w

    def reduce(self, y):
        """Partial -> replicated (the sum)."""
        return y

    def scatter(self, y, dim: int):
        """Partial -> this rank's block of the sum along ``dim``."""
        return y

    def split(self, y, dim: int):
        """Replicated -> this rank's block along ``dim``."""
        return y

    def gather(self, t, dim: int):
        """Blocks along ``dim`` -> the whole tensor (every rank computed
        the same thing: the backward slices)."""
        return t

    def max(self, t):
        """The elementwise max over the ranks, with no gradient."""
        return t

    def enter(self, x):
        """The residual stream -> replicated (a block's input)."""
        return x

    def exit(self, y):
        """A block's partial output -> the residual stream's layout."""
        return y

    def exit_whole(self, y):
        """A block's replicated output -> the residual stream's layout."""
        return y


WHOLE = Whole()


def zeros(shape, gen, device):
    return torch.zeros(tuple(shape), dtype=torch.float32, device=device)


def const(value: float) -> Init:
    return lambda shape, gen, device: torch.full(tuple(shape), value,
                                                 dtype=torch.float32, device=device)


def normal(scale: float) -> Init:
    return lambda shape, gen, device: scale * torch.randn(
        tuple(shape), generator=gen, dtype=torch.float32, device=device)


def dense(scale: Optional[float] = None) -> Init:
    """The reference's ``_dense``: N(0, s^2) with s = 1/sqrt(shape[-2])
    (shape[-1] for a vector) unless given."""
    def init(shape, gen, device):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        return normal(s)(shape, gen, device)
    return init


def promote(*ts: torch.Tensor):
    """The tensors cast to their common dtype (``jnp``'s promotion)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = promote(a, b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = promote(a, b)
    return torch.einsum(eq, a, b)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rms_norm(x, scale, eps: float = 1e-6):
    """Variance reduction in f32; the elementwise apply stays in the input
    dtype.  ``scale`` is stored as a delta from 1."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * (1.0 + scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """x [..., S, H, hd]; positions broadcast against [..., S].  Rotates the
    two halves of hd (not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                     # [hd/2]
    ang = positions[..., None].float() * freqs                  # [..., S, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    cos = cos[..., None, :]                                     # over heads
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Flash attention with a hand-written backward (tiles recomputed)
# ---------------------------------------------------------------------------

def _chunks(q, k, q_chunk: int, kv_chunk: int):
    """(B, S, Hkv, G, hd, Cq, Ck, nq, nk) of a causal GQA call; the chunks
    must divide S."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    Cq, Ck = min(q_chunk, S), min(kv_chunk, S)
    assert S % Cq == 0 and S % Ck == 0, (S, Cq, Ck)
    return B, S, Hkv, H // Hkv, hd, Cq, Ck, S // Cq, S // Ck


def _acc_dtype(dt: torch.dtype) -> torch.dtype:
    """float32 for float32 and narrower inputs (the reference's), float64
    for float64 ones (``gradcheck``)."""
    return torch.promote_types(dt, torch.float32)


def _causal_mask(qi: int, j: int, Cq: int, Ck: int, device) -> torch.Tensor:
    """[1, Cq, 1, 1, Ck]: query qi*Cq + a may see key j*Ck + b."""
    gq = qi * Cq + torch.arange(Cq, device=device)
    gk = j * Ck + torch.arange(Ck, device=device)
    return (gq[:, None] >= gk[None, :])[None, :, None, None, :]


def _flash_fwd_impl(q, k, v, q_chunk: int, kv_chunk: int):
    """The reference's ``_flash_fwd_impl``: (out [B,S,H,hd], m, l), with
    m, l [nq, B, Cq, Hkv, G] the online softmax's row max and sum."""
    B, S, Hkv, G, hd, Cq, Ck, nq, nk = _chunks(q, k, q_chunk, kv_chunk)
    acc, dev = _acc_dtype(q.dtype), q.device
    scale = 1.0 / math.sqrt(hd)
    qs = q.reshape(B, nq, Cq, Hkv, G, hd)
    ks = k.reshape(B, nk, Ck, Hkv, hd)
    vs = v.reshape(B, nk, Ck, Hkv, hd)
    outs, ms, ls = [], [], []
    for qi in range(nq):
        q_i = qs[:, qi].to(acc)
        m = torch.full((B, Cq, Hkv, G), -math.inf, dtype=acc, device=dev)
        l = torch.zeros((B, Cq, Hkv, G), dtype=acc, device=dev)
        o = torch.zeros((B, Cq, Hkv, G, hd), dtype=acc, device=dev)
        for j in range(nk):
            s = torch.einsum("bqhgd,bchd->bqhgc", q_i, ks[:, j].to(acc)) * scale
            mask = _causal_mask(qi, j, Cq, Ck, dev)
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bqhgc,bchd->bqhgd", p, vs[:, j].to(acc))
            m = m_new
        outs.append((o / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype))
        ms.append(m)
        ls.append(l)
    out = torch.stack(outs, dim=1).reshape(B, S, Hkv * G, hd)
    return out, torch.stack(ms), torch.stack(ls)


def _flash_cv_bwd(q, k, v, out, ms, ls, dout, q_chunk: int, kv_chunk: int):
    """The reference's ``_flash_cv_bwd``: every [Cq, Ck] probability tile is
    recomputed from (q, k, m, l); dq, dk and dv accumulate in float32 across
    chunks, the GQA group summed into dk and dv."""
    B, S, Hkv, G, hd, Cq, Ck, nq, nk = _chunks(q, k, q_chunk, kv_chunk)
    acc, dev = _acc_dtype(q.dtype), q.device
    scale = 1.0 / math.sqrt(hd)
    qs = q.reshape(B, nq, Cq, Hkv, G, hd)
    ks = k.reshape(B, nk, Ck, Hkv, hd)
    vs = v.reshape(B, nk, Ck, Hkv, hd)
    dos = dout.reshape(B, nq, Cq, Hkv, G, hd)
    os_ = out.reshape(B, nq, Cq, Hkv, G, hd)
    dk = torch.zeros((B, nk, Ck, Hkv, hd), dtype=acc, device=dev)
    dv = torch.zeros((B, nk, Ck, Hkv, hd), dtype=acc, device=dev)
    dqs = []
    for qi in range(nq):
        q_i, do_i = qs[:, qi].to(acc), dos[:, qi].to(acc)
        # D = rowsum(dout * out)  [B,Cq,Hkv,G]
        D = torch.einsum("bqhgd,bqhgd->bqhg", do_i, os_[:, qi].to(acc))
        m_i, l_i = ms[qi], ls[qi]
        m_safe = torch.where(torch.isfinite(m_i), m_i, 0.0)
        l_safe = torch.clamp_min(l_i, 1e-30)
        dq_i = torch.zeros((B, Cq, Hkv, G, hd), dtype=acc, device=dev)
        for j in range(nk):
            k_j, v_j = ks[:, j].to(acc), vs[:, j].to(acc)
            s = torch.einsum("bqhgd,bchd->bqhgc", q_i, k_j) * scale
            mask = _causal_mask(qi, j, Cq, Ck, dev)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0) / l_safe[..., None]
            dv[:, j] += torch.einsum("bqhgc,bqhgd->bchd", p, do_i)
            dp = torch.einsum("bqhgd,bchd->bqhgc", do_i, v_j)
            ds = p * (dp - D[..., None]) * scale
            dq_i = dq_i + torch.einsum("bqhgc,bchd->bqhgd", ds, k_j)
            dk[:, j] += torch.einsum("bqhgc,bqhgd->bchd", ds, q_i)
        dqs.append(dq_i)
    dq = torch.stack(dqs, dim=1).reshape(q.shape).to(q.dtype)
    return dq, dk.reshape(k.shape).to(k.dtype), dv.reshape(v.shape).to(v.dtype)


class _FlashCV(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, q_chunk, kv_chunk):
        out, ms, ls = _flash_fwd_impl(q, k, v, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, ms, ls)
        ctx.chunks = (q_chunk, kv_chunk)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, ms, ls = ctx.saved_tensors
        return (*_flash_cv_bwd(q, k, v, out, ms, ls, dout, *ctx.chunks), None, None)


def flash_attention_cv(q, k, v, q_chunk: int = 1024, kv_chunk: int = 1024):
    """Causal GQA attention with the FlashAttention-2 style backward: the
    forward keeps only (q, k, v, out) and the per-chunk row max ``m`` and
    sum ``l``; the backward recomputes each [Cq, Ck] probability tile, so
    nothing O(S^2) is stashed.  q [B,S,H,hd]; k,v [B,S,Hkv,hd]."""
    return _FlashCV.apply(q, k, v, q_chunk, kv_chunk)


# ---------------------------------------------------------------------------
# Flash-style attention (double-chunk loop, online softmax)
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    q_chunk: int = 512, kv_chunk: int = 512,
                    window: Optional[int] = None,
                    causal_skip: bool = False,
                    remat_qchunk: bool = False):
    """q [B,S,H,hd]; k,v [B,S,Hkv,hd] (GQA: H = Hkv * G).  Returns [B,S,H,hd].

    ``causal_skip``: bound the inner KV loop at each query chunk's causal
    horizon (chunks j <= qi), which skips the masked upper triangle.  The
    reference cannot differentiate it (a dynamic ``fori_loop`` bound), so
    training leaves it off.

    ``remat_qchunk``: checkpoint each query chunk, so the backward
    recomputes its [Cq, Ck] tiles instead of stashing them (only while
    autograd records).
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    Cq = min(q_chunk, S)
    Ck = min(kv_chunk, S)
    assert S % Cq == 0 and S % Ck == 0, (S, Cq, Ck)
    nq, nk = S // Cq, S // Ck
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qs = q.reshape(B, nq, Cq, Hkv, G, hd)
    ks = k.reshape(B, nk, Ck, Hkv, hd)
    vs = v.reshape(B, nk, Ck, Hkv, hd)
    q_idx = torch.arange(Cq, device=dev)
    k_idx = torch.arange(Ck, device=dev)

    def one_q_chunk(qi: int, q_i):
        q_i = q_i.float()
        # online-softmax state
        m = torch.full((B, Cq, Hkv, G), -math.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Cq, Hkv, G), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Cq, Hkv, G, hd), dtype=torch.float32, device=dev)
        # dynamic horizon: only kv chunks j <= qi contribute
        horizon = qi + 1 if (causal_skip and causal and Cq == Ck) else nk
        for j in range(horizon):
            s = torch.einsum("bqhgd,bchd->bqhgc", q_i, ks[:, j].float()) * scale
            gq = qi * Cq + q_idx                                 # global positions
            gk = j * Ck + k_idx
            mask = torch.ones((Cq, Ck), dtype=torch.bool, device=dev)
            if causal:
                mask &= gq[:, None] >= gk[None, :]
            if window is not None:
                mask &= gq[:, None] - gk[None, :] < window
            mask = mask[None, :, None, None, :]
            s = torch.where(mask, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(mask, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bqhgc,bchd->bqhgd", p, vs[:, j].float())
            m = m_new
        return (o / torch.clamp_min(l[..., None], 1e-30)).to(q.dtype)

    remat = remat_qchunk and torch.is_grad_enabled()
    outs = [checkpoint(one_q_chunk, qi, qs[:, qi], use_reentrant=False) if remat
            else one_q_chunk(qi, qs[:, qi]) for qi in range(nq)]
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


def local_attention(q, k, v, *, window: int, q_chunk: int = 512):
    """Banded sliding-window causal attention: each query chunk attends to a
    slice of [window + Cq] keys, so the work is O(S * window)."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    Cq = min(q_chunk, S)
    assert S % Cq == 0
    nq = S // Cq
    Wk = min(window + Cq, S)        # keys visible to one q chunk
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    qs = q.reshape(B, nq, Cq, Hkv, G, hd)
    outs = []
    for qi in range(nq):
        start = min(max(qi * Cq + Cq - Wk, 0), S - Wk)
        k_w = k[:, start:start + Wk]
        v_w = v[:, start:start + Wk]
        s = torch.einsum("bqhgd,bchd->bqhgc", qs[:, qi].float(), k_w.float()) * scale
        gq = qi * Cq + torch.arange(Cq, device=dev)
        gk = start + torch.arange(Wk, device=dev)
        mask = (gq[:, None] >= gk[None, :]) & (gq[:, None] - gk[None, :] < window)
        s = torch.where(mask[None, :, None, None, :], s, -math.inf)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bqhgc,bchd->bqhgd", p, v_w.float())
        outs.append(out.to(q.dtype))
    return torch.stack(outs, dim=1).reshape(B, S, H, hd)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: Optional[int] = None):
    """One-token attention over a padded cache.

    q [B,H,hd]; caches [B,Smax,Hkv,hd]; pos (#valid positions BEFORE this
    token; the new token's kv must already be written at pos).
    """
    B, H, hd = q.shape
    Hkv = k_cache.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Hkv, G, hd)
    s = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float()) * scale
    idx = torch.arange(k_cache.shape[1], device=q.device)
    mask = idx <= pos
    if window is not None:
        mask &= idx > pos - window
    s = torch.where(mask[None, None, None, :], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# FFN (SwiGLU) and MoE
# ---------------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(matmul(x, w_gate)) * matmul(x, w_up)
    return matmul(h, w_down)


def top_k_stable(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: on ties the lowest index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn_tp(x, router_w, w_gate, w_up, w_down, *, top_k: int,
               capacity_factor: float = 1.25, group=None):
    """Expert-parallel MoE dispatch over ``group`` (the model axis):
    activations are replicated over the group, the expert weights are this
    rank's [E/n, d, f] block; each rank compacts ONLY the (token, k) pairs
    routed to its local experts (the drop slot is ``E_loc``, the order a
    stable sort), runs its experts at capacity ``C = ceil(N * top_k / E *
    capacity_factor)`` of the local N, and the per-rank partial outputs are
    summed with one all-reduce (the combine).

    Gradients are those of the dense ``moe_ffn`` over the same tokens: the
    combine's backward passes the (replicated) cotangent on, and the
    tokens and router probabilities that feed the local experts go through
    ``comm.copy_to``, whose backward sums the ranks' partial cotangents.
    x [N, d] local tokens; returns ([N, d], aux), aux over the local N."""
    from ..distributed import comm
    N, d = x.shape
    E_loc = w_gate.shape[0]
    n_ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    E = E_loc * n_ranks
    e_lo = rank * E_loc
    dev = x.device

    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, top_e = top_k_stable(comm.copy_to(probs, group), top_k)   # [N, k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    eflat = top_e.reshape(-1)                                    # [N*k]
    frac = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eflat, torch.ones(N * top_k, dtype=torch.float32, device=dev)) / (N * top_k)
    aux = E * torch.sum(frac * probs.mean(0))

    # local compaction: (token, k) pairs whose expert lives on this rank
    local = (eflat >= e_lo) & (eflat < e_lo + E_loc)
    le = torch.where(local, eflat - e_lo, E_loc)                 # E_loc = drop
    order = torch.argsort(le, stable=True)                       # locals first
    sorted_e = le[order]
    C = int(math.ceil(N * top_k / E * capacity_factor))
    grp = torch.searchsorted(sorted_e, torch.arange(E_loc + 1, device=dev))
    pos = torch.arange(N * top_k, device=dev) - grp[torch.clamp(sorted_e, 0, E_loc)]
    keep = (sorted_e < E_loc) & (pos < C)
    slot = torch.where(keep, sorted_e * C + pos, E_loc * C)     # E_loc*C = trash row
    token_of = order // top_k

    xe = comm.copy_to(x, group)
    xg = torch.zeros((E_loc * C + 1, d), dtype=x.dtype, device=dev)
    xg[slot] = xe[token_of]
    xg = xg[:E_loc * C].reshape(E_loc, C, d)
    h = F.silu(einsum("ecd,edf->ecf", xg, w_gate)) * einsum("ecd,edf->ecf", xg, w_up)
    ye = einsum("ecf,efd->ecd", h, w_down).reshape(E_loc * C, d)

    y_sorted = ye[torch.clamp(slot, 0, E_loc * C - 1)]
    gates_sorted = gate_vals.reshape(-1)[order]
    w = torch.where(keep, gates_sorted, 0.0).float()
    y_partial = torch.zeros((N, d), dtype=torch.float32, device=dev).index_add_(
        0, token_of, y_sorted.float() * w[:, None])
    y = comm.reduce_sum(y_partial, group)        # the combine (one all-reduce)
    return y.to(x.dtype), aux


def make_tp_moe_fn(mesh, dp_spec, cfg):
    """``forward``'s ``moe_fn`` running ``moe_ffn_tp`` over the mesh's
    ``model`` axis (a ``launch.mesh.Mesh``).  ``x`` is this rank's batch
    shard (the whole batch where ``dp_spec`` is None); whole expert leaves
    are sliced to this rank's ``model`` block, as ``shard_map``'s in_specs
    do, and blocks already local are used as given.  The aux loss is
    averaged over the dp axes.  Shared experts stay dense
    (``transformer._apply_ffn``)."""
    from ..distributed import comm
    group = mesh.group("model")
    n, r = mesh.shape["model"], mesh.index("model")
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not divide a model axis of {n}")
    e_loc = cfg.n_experts // n
    dp_groups = [mesh.group(a) for a in ("pod", "data") if a in mesh.axis_names]

    def local(w):
        return w if w.shape[0] == e_loc else w[r * e_loc:(r + 1) * e_loc]

    def moe_fn(p, x):
        B, S, d = x.shape
        y, aux = moe_ffn_tp(x.reshape(B * S, d), p.router, local(p.e_gate),
                            local(p.e_up), local(p.e_down), top_k=cfg.top_k,
                            capacity_factor=cfg.capacity_factor, group=group)
        for g in dp_groups:
            aux = comm.mean(aux, g, scale_grad=dp_spec is not None)
        return y.reshape(B, S, d), aux
    return moe_fn


def moe_ffn(x, router_w, w_gate, w_up, w_down, *, top_k: int,
            capacity_factor: float = 1.25):
    """Sort-based static-capacity MoE dispatch.

    x [N, d]; router_w [d, E]; expert weights [E, d, ff] / [E, ff, d].
    Returns ([N, d] output, aux load-balancing loss).  The capacity C
    depends on N, and which (token, k) pairs are dropped at C follows the
    stable sort by expert, as in the reference.
    """
    N, d = x.shape
    E = router_w.shape[1]
    dev = x.device
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                        # [N, E]
    gate_vals, top_e = top_k_stable(probs, top_k)                   # [N, k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)                   # renormalize

    # switch-style aux loss: E * sum_e (frac_tokens_e * mean_prob_e)
    eflat = top_e.reshape(-1)                                    # [N*k]
    frac = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, eflat, torch.ones(N * top_k, dtype=torch.float32, device=dev)) / (N * top_k)
    aux = E * torch.sum(frac * probs.mean(0))

    C = int(math.ceil(N * top_k / E * capacity_factor))
    order = torch.argsort(eflat, stable=True)                    # group by expert
    sorted_e = eflat[order]
    grp_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(N * top_k, device=dev) - grp_start[sorted_e]
    keep = pos_in_e < C
    # dropped pairs go to the trash row E*C (``mode="drop"`` in the reference)
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    token_of = order // top_k

    xg = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    xg[slot] = x[token_of]
    xg = xg[:E * C].reshape(E, C, d)
    h = F.silu(einsum("ecd,edf->ecf", xg, w_gate)) * einsum("ecd,edf->ecf", xg, w_up)
    ye = einsum("ecf,efd->ecd", h, w_down).reshape(E * C, d)

    # combine: gather each (token, k) result and weight by its gate
    y_sorted = ye[torch.clamp(slot, 0, E * C - 1)]
    gates_sorted = gate_vals.reshape(-1)[order]
    w = torch.where(keep, gates_sorted, 0.0).float()
    y = torch.zeros((N, d), dtype=torch.float32, device=dev).index_add_(
        0, token_of, y_sorted.float() * w[:, None])
    return y.to(x.dtype), aux

