"""RG-LRU recurrent block (RecurrentGemma / Griffin, De et al., 2024).

The Real-Gated Linear Recurrent Unit is a *diagonal* linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t),  r_t, i_t input-dependent gates.

The JAX package's ``models/rglru.py`` in PyTorch.  Prefill evaluates the
recurrence with a log-depth scan over S (Hillis–Steele doubling with the
reference's ``combine``, in place of ``jax.lax.associative_scan``);
decode is the exact single step.  State is O(1) in sequence length.

Over a mesh's ``model`` axis (``tp``) the lru width is cut: ``w_in``,
``w_gate_branch``, ``conv_w``, ``lam`` and ``w_out``'s rows are this rank's
block, the gates' [w, w] products sum each rank's rows and keep its
columns (a reduce-scatter), the scan and the state run on the local
width, and ``w_out``'s partial output is summed.
"""
from __future__ import annotations

from typing import Dict

import torch

from .layers import WHOLE, Leaves, gelu, matmul, normal, rms_norm, zeros
from .xlstm import _causal_conv1d

_C = 8.0  # the paper's fixed gate sharpness


def _lambda_init(shape, gen, device):
    """Lambda so a^(1/c) is uniform in [0.9, 0.999] (paper appendix)."""
    u = 0.9 + (0.999 - 0.9) * torch.rand(tuple(shape), generator=gen,
                                         dtype=torch.float32, device=device)
    return torch.log(torch.expm1(-torch.log(u)))            # inverse softplus


def rglru_leaves(block: Leaves, d_model: int, width: int, conv_width: int,
                 dtype, device) -> None:
    """The reference's ``rglru_init`` leaves, registered on ``block``."""
    s = normal(0.02)
    f32 = torch.float32
    block.leaf("norm", (d_model,), f32, zeros, device)
    block.leaf("w_in", (d_model, width), dtype, s, device)
    block.leaf("w_gate_branch", (d_model, width), dtype, s, device)
    block.leaf("conv_w", (conv_width, width), f32, normal(0.1), device)
    block.leaf("w_rgate", (width, width), dtype, s, device)     # r_t gate
    block.leaf("w_igate", (width, width), dtype, s, device)     # i_t gate
    block.leaf("lam", (width,), f32, _lambda_init, device)
    block.leaf("w_out", (width, d_model), dtype, s, device)


def rglru_state_init(batch: int, width: int, conv_width: int = 4,
                     device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=torch.bfloat16,
                            device=device),
    }


def _gates(params, xc, tp=WHOLE):
    r = torch.sigmoid(tp.scatter(xc.float() @ params.w_rgate.float(), -1))
    i = torch.sigmoid(tp.scatter(xc.float() @ params.w_igate.float(), -1))
    softplus = torch.logaddexp(params.lam, torch.zeros_like(params.lam))
    log_a = -_C * softplus * r
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xc.float())
    return a, gated_x


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t over axis 1 (h_{-1} = 0)
    in ceil(log2 S) doubling steps, each the reference's ``combine``
    ((al, bl), (ar, br)) -> (al * ar, ar * bl + br) of element t - k into
    element t."""
    S = a.shape[1]
    k = 1
    while k < S:
        a_prev, b_prev = a[:, :S - k], b[:, :S - k]
        a_cur, b_cur = a[:, k:], b[:, k:]
        a = torch.cat([a[:, :k], a_prev * a_cur], dim=1)
        b = torch.cat([b[:, :k], a_cur * b_prev + b_cur], dim=1)
        k *= 2
    return b


def rglru_apply(params, x, state=None, *, tp=WHOLE):
    """x [B,S,d]; returns (y [B,S,d], new_state).  Log-depth scan over S for
    S > 1; exact single step for S == 1 (decode).  The conv state comes
    back rounded to bf16 in every config, as in the reference.  Under
    ``tp`` x and y are in the residual stream's layout, and the state is
    on the local width."""
    B, S = x.shape[:2]
    width = params.w_in.shape[1]
    cut = tp.cut(width, params.w_rgate.shape[1])      # this rank's block of the lru width
    if state is None:
        state = rglru_state_init(B, width, params.conv_w.shape[0], x.device)
    xn = rms_norm(tp.enter(x), params.norm)
    if cut:
        xn = tp.cols(xn)
    xi = matmul(xn, params.w_in)                        # [B,S,w]
    xg = gelu(matmul(xn, params.w_gate_branch))        # gate branch
    xc, conv_cache = _causal_conv1d(xi, params.conv_w, state["conv"])
    a, gx = _gates(params, xc, tp if cut else WHOLE)    # [B,S,w] f32

    if S == 1:
        h = a[:, 0] * state["h"] + gx[:, 0]
        hs = h[:, None]
    else:
        # fold the carried-in state into the first element, then scan
        gx = torch.cat([gx[:, :1] + (a[:, 0] * state["h"])[:, None], gx[:, 1:]], dim=1)
        hs = linear_scan(a, gx)
        h = hs[:, -1]

    y = matmul(hs.to(x.dtype) * xg, params.w_out)
    y = tp.exit(y) if cut else tp.exit_whole(y)
    return x + y, {"h": h, "conv": conv_cache.to(torch.bfloat16)}

