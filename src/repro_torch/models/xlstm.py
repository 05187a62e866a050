"""xLSTM blocks (Beck et al., 2024): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory with recurrent gate connections).

The JAX package's ``models/xlstm.py`` in PyTorch: both are exact
recurrences, a loop over time (the reference's ``lax.scan``); mLSTM also
has the exact chunkwise-parallel form.  A single step is decode.  States
are O(1) in sequence length.

Simplifications vs. the paper (as in the reference): block-diagonal
projections are dense per head; sLSTM omits the post-block projection
factor, mLSTM uses projection factor 2.  sLSTM's ``remat_chunk``
checkpoints each chunk of steps while autograd records; it changes what
the backward stashes, not the numbers.

Over a mesh's ``model`` axis (``tp``): mLSTM's up width is cut
(``w_up``, ``w_gate``, ``conv_w`` column-parallel; ``w_q``, ``w_k``,
``w_v``, ``w_i`` and ``w_f`` take the cut width as their input, so their
partial products are summed), the recurrence runs whole on every rank,
and each rank keeps its columns of h for the row-parallel ``w_down``.
sLSTM's heads are cut (``w_x``'s columns and ``r_h``: the recurrence is
per head) and ``w_out`` is row-parallel; where ``w_x``'s columns are cut
but the heads are not, the gate inputs are gathered and the recurrence
runs whole.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import WHOLE, Leaves, const, matmul, normal, rms_norm, zeros


def _causal_conv1d(x, w, cache=None):
    """x [B,S,D], w [cw, D] depthwise.  Returns (y [B,S,D], new_cache).

    ``w`` is float32, so ``y`` is float32 whatever x's dtype (JAX
    promotes the product)."""
    cw = w.shape[0]
    if cache is None:
        xp = F.pad(x, (0, 0, cw - 1, 0))
    else:
        dt = torch.promote_types(cache.dtype, x.dtype)
        xp = torch.cat([cache.to(dt), x.to(dt)], dim=1)   # [B, cw-1+S, D]
    S = x.shape[1]
    y = sum(xp[:, i:i + S] * w[i] for i in range(cw))
    new_cache = xp[:, xp.shape[1] - (cw - 1):]
    return F.silu(y), new_cache


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTMBlock(Leaves):
    """The reference's ``mlstm_init`` leaves."""

    def __init__(self, d_model: int, n_heads: int, conv_width: int = 4,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        up = 2 * d_model
        f32 = torch.float32
        s = normal(0.02)
        self.leaf("norm", (d_model,), f32, zeros, device)
        self.leaf("w_up", (d_model, up), dtype, s, device)
        self.leaf("w_gate", (d_model, up), dtype, s, device)
        self.leaf("conv_w", (conv_width, up), f32, normal(0.1), device)
        self.leaf("w_q", (up, up), dtype, s, device)
        self.leaf("w_k", (up, up), dtype, s, device)
        self.leaf("w_v", (up, up), dtype, s, device)
        self.leaf("w_i", (up, n_heads), f32, s, device)
        self.leaf("b_i", (n_heads,), f32, zeros, device)
        self.leaf("w_f", (up, n_heads), f32, s, device)
        self.leaf("b_f", (n_heads,), f32, const(3.0), device)   # forget-gate bias
        self.leaf("out_norm", (up,), f32, zeros, device)
        self.leaf("w_down", (up, d_model), dtype, s, device)


def mlstm_state_init(batch: int, d_model: int, n_heads: int,
                     conv_width: int = 4, device=None) -> Dict[str, torch.Tensor]:
    up = 2 * d_model
    hd = up // n_heads
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, n_heads, hd, hd), dtype=f32, device=device),
        "n": torch.zeros((batch, n_heads, hd), dtype=f32, device=device),
        "m": torch.full((batch, n_heads), -math.inf, dtype=f32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, up), dtype=torch.bfloat16,
                            device=device),
    }


def _mlstm_step(state, qkvif):
    """One stabilized mLSTM recurrence step (per head)."""
    q, k_, v, logi, logf = qkvif      # q/k/v [B,H,hd]; logi/logf [B,H]
    C, n, m = state
    m_new = torch.maximum(logf + m, logi)
    m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
    i_ = torch.exp(logi - m_safe)
    f_ = torch.where(torch.isfinite(m), torch.exp(logf + m - m_safe), 0.0)
    C_new = f_[..., None, None] * C + i_[..., None, None] * (
        v[..., None, :] * k_[..., :, None])           # [B,H,hd_k,hd_v]
    n_new = f_[..., None] * n + i_[..., None] * k_
    h_num = torch.einsum("bhkv,bhk->bhv", C_new, q)
    h_den = torch.clamp_min(torch.abs(torch.einsum("bhk,bhk->bh", n_new, q)), 1.0)
    h = h_num / h_den[..., None]
    return (C_new, n_new, m_new), h


def mlstm_apply(params, x, state=None, *, n_heads: int, chunk: int = 0, tp=WHOLE):
    """x [B,S,d] (S may be 1 for decode).  Returns (y [B,S,d], new_state).

    ``chunk > 0`` selects the exact chunkwise-parallel evaluation of the
    same recurrence.  The conv state comes back rounded to bf16 in every
    config, as in the reference.  Under ``tp`` x and y are in the residual
    stream's layout; C, n and m are whole and the conv state is on the
    local up width.
    """
    xf = tp.enter(x)
    B, S, d = xf.shape
    up = 2 * d
    hd = up // n_heads
    cut = tp.cut(params.w_up.shape[1], up)
    total = tp.reduce if cut else (lambda t: t)
    if state is None:
        state = mlstm_state_init(B, d, n_heads, params.conv_w.shape[0], x.device)
        state["conv"] = state["conv"][..., :params.conv_w.shape[1]]
    xn = rms_norm(xf, params.norm)
    if cut:
        xn = tp.cols(xn)
    xu = matmul(xn, params.w_up)
    xz = matmul(xn, params.w_gate)
    xc, conv_cache = _causal_conv1d(xu, params.conv_w, state["conv"])

    def heads(t, w):
        return total(matmul(t, w)).reshape(B, S, n_heads, hd)

    q = heads(xc, params.w_q).float() / math.sqrt(hd)
    k_ = heads(xc, params.w_k).float() / math.sqrt(hd)
    v = heads(xu, params.w_v).float()
    logi = total(xu.float() @ params.w_i) + params.b_i           # [B,S,H]
    logf = F.logsigmoid(total(xu.float() @ params.w_f) + params.b_f)

    carry = (state["C"], state["n"], state["m"])
    if chunk and S > 1 and S % min(chunk, S) == 0:
        (C, n, m), h = _mlstm_chunkwise(q, k_, v, logi, logf, carry, min(chunk, S))
    else:
        hs = []
        for t in range(S):
            carry, ht = _mlstm_step(carry, (q[:, t], k_[:, t], v[:, t],
                                            logi[:, t], logf[:, t]))
            hs.append(ht)
        (C, n, m), h = carry, torch.stack(hs, dim=1)            # [B,S,H,hd]
    h = h.reshape(B, S, up)
    h = rms_norm(h.to(x.dtype), params.out_norm)
    if cut:
        h = tp.split(h, -1)
    y = matmul(h * F.silu(xz), params.w_down)
    y = tp.exit(y) if cut else tp.exit_whole(y)
    new_state = {"C": C, "n": n, "m": m, "conv": conv_cache.to(torch.bfloat16)}
    return x + y, new_state


def _mlstm_chunkwise(q, k_, v, logi, logf, carry, T: int):
    """Exact chunkwise-parallel mLSTM (stabilized, matches _mlstm_step).

    Within a chunk of length T: F_t = sum_{s<=t} logf_s, u_s = logi_s - F_s,
    g_t = max(m_prev, cummax_{s<=t} u_s), m_t = F_t + g_t, and

      h_t  = [ exp(m_prev - g_t) * q_t C_prev
               + sum_{s<=t} exp(u_s - g_t) (q_t.k_s) v_s ] / den_t
      den_t = max(|exp(m_prev - g_t) * q_t.n_prev
               + sum_{s<=t} exp(u_s - g_t) (q_t.k_s)|, 1)

    i.e. one [T,T] decay-masked attention matmul per chunk plus a rank-T
    carry update.
    """
    B, S, H, hd = q.shape
    nc = S // T
    C, n, m = carry                         # [B,H,hd,hd], [B,H,hd], [B,H]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    hs = []
    for c in range(nc):
        sl = slice(c * T, (c + 1) * T)
        qc, kc, vc, ic, fc = q[:, sl], k_[:, sl], v[:, sl], logi[:, sl], logf[:, sl]
        F_ = torch.cumsum(fc, dim=1)        # [B,T,H]
        u = ic - F_                         # [B,T,H]
        g = torch.maximum(m[:, None], torch.cummax(u, dim=1).values)   # [B,T,H]
        # intra-chunk decay-masked scores
        scores = torch.einsum("bthd,bshd->bhts", qc, kc)                # [B,H,T,T]
        w = torch.exp(u.transpose(1, 2)[:, :, None, :]
                      - g.transpose(1, 2)[:, :, :, None])               # [B,H,T,S<=T]
        wts = torch.where(mask[None, None], scores * w, 0.0)
        # carry path
        cdec = torch.exp(m[:, None] - g)                                # [B,T,H]
        h_carry = torch.einsum("bthd,bhde->bthe", qc, C) * cdec[..., None]
        n_carry = torch.einsum("bthd,bhd->bth", qc, n) * cdec
        h_num = h_carry + torch.einsum("bhts,bshe->bthe", wts, vc)
        den = n_carry + wts.sum(dim=-1).transpose(1, 2)                 # [B,T,H]
        hs.append(h_num / torch.clamp_min(torch.abs(den), 1.0)[..., None])
        # chunk-end carry update (position T): m_T = F_T + g_T
        FT = F_[:, -1]                                                  # [B,H]
        gT = g[:, -1]
        m_new = FT + gT
        dec_prev = torch.exp(m + FT - m_new)                            # [B,H]
        kv_w = torch.exp(u - gT[:, None])                               # [B,T,H]
        C = dec_prev[..., None, None] * C + torch.einsum(
            "bthd,bthe,bth->bhde", kc, vc, kv_w)
        n = dec_prev[..., None] * n + torch.einsum("bthd,bth->bhd", kc, kv_w)
        m = m_new
    return (C, n, m), torch.cat(hs, dim=1)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_bias(shape, gen, device):
    d = shape[0] // 4
    b = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    b[d:2 * d] = 3.0                       # forget-gate bias
    return b


class SLSTMBlock(Leaves):
    """The reference's ``slstm_init`` leaves (gates i, f, z, o packed)."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        hd = d_model // n_heads
        s = normal(0.02)
        self.leaf("norm", (d_model,), torch.float32, zeros, device)
        self.leaf("w_x", (d_model, 4 * d_model), dtype, s, device)
        self.leaf("r_h", (n_heads, hd, 4 * hd), dtype, s, device)
        self.leaf("b", (4 * d_model,), torch.float32, _slstm_bias, device)
        self.leaf("w_out", (d_model, d_model), dtype, s, device)


def slstm_state_init(batch: int, d_model: int, n_heads: int,
                     device=None) -> Dict[str, torch.Tensor]:
    hd = d_model // n_heads
    f32 = torch.float32
    z = lambda: torch.zeros((batch, n_heads, hd), dtype=f32, device=device)
    return {"c": z(), "n": z(),
            "m": torch.full((batch, n_heads, hd), -math.inf, dtype=f32, device=device),
            "h": z()}


def slstm_apply(params, x, state=None, *, n_heads: int, remat_chunk: int = 0,
                tp=WHOLE):
    """Exact sequential sLSTM (recurrent gate connections force a true scan).

    ``remat_chunk > 0`` (and S a multiple of it, longer than it): each chunk
    of T steps is checkpointed, so the backward stashes per-chunk states
    instead of per-step ones.  The recurrence itself cannot be
    parallelized, so only the stash shrinks, not the depth.  Under ``tp``
    x and y are in the residual stream's layout and the state holds the
    block's heads (this rank's where they are cut).
    """
    xf = tp.enter(x)
    B, S, d = xf.shape
    hd = d // n_heads
    H = params.r_h.shape[0]
    heads = tp.cut(H, n_heads)
    cols = tp.cut(params.w_x.shape[1], 4 * d)
    if state is None:
        state = slstm_state_init(B, H * hd, H, x.device)
    xn = rms_norm(xf, params.norm)
    if cols:
        xn = tp.cols(xn)
    gx = matmul(xn, params.w_x).float()                          # [B,S,4d]
    if heads:
        # w_x's column block r is heads [r H/M, (r+1) H/M) of the [H, 4hd]
        # reshape (M divides H): each rank's gate inputs are its heads'
        gx = gx + tp.part(params.b).narrow(0, tp.offset(4 * d), gx.shape[-1])
    else:
        gx = tp.gather(gx, -1) if cols else gx
        gx = gx + params.b
    gx = gx.reshape(B, S, H, 4 * hd)
    r_h = params.r_h.float()

    def steps(carry, gxc):
        """The recurrence over gxc [B,T,H,4hd]: (carry, h [B,T,H,hd])."""
        c, n, m, h = carry
        hs = []
        for t in range(gxc.shape[1]):
            rec = torch.einsum("bhd,hdk->bhk", h, r_h)
            g = gxc[:, t] + rec                             # [B,H,4hd]
            gi, gf, gz, go = torch.chunk(g, 4, dim=-1)
            logf = F.logsigmoid(gf)
            m_new = torch.maximum(logf + m, gi)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            i_ = torch.exp(gi - m_safe)
            f_ = torch.where(torch.isfinite(m), torch.exp(logf + m - m_safe), 0.0)
            c = f_ * c + i_ * torch.tanh(gz)
            n = f_ * n + i_
            h = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
            m = m_new
            hs.append(h)
        return (c, n, m, h), torch.stack(hs, dim=1)

    carry = (state["c"], state["n"], state["m"], state["h"])
    T = min(remat_chunk, S) if remat_chunk else 0
    if T and S % T == 0 and S > T and torch.is_grad_enabled():
        hs = []
        for i in range(S // T):
            carry, h_c = checkpoint(steps, carry, gx[:, i * T:(i + 1) * T],
                                    use_reentrant=False)
            hs.append(h_c)
        hs = torch.cat(hs, dim=1)
    else:
        carry, hs = steps(carry, gx)
    c, n, m, h = carry
    hs = hs.reshape(B, S, H * hd).to(x.dtype)
    if heads:
        y = tp.exit(matmul(hs, params.w_out))
    elif tp.cut(params.w_out.shape[0], d):
        y = tp.exit(matmul(tp.split(hs, -1), params.w_out))
    else:
        y = tp.exit_whole(matmul(hs, params.w_out))
    return x + y, {"c": c, "n": n, "m": m, "h": h}
