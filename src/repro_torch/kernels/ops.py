"""Engine-facing adapters around the port's kernels.

``fused_frontier`` packs engine-level arguments (binding rows, steps, the
plan, the partition's locality tables) into the kernel's layout and
calls the device-dispatching wrapper in kernels/fused_frontier.py: the
CUDA kernel on CUDA tensors, its plain version on CPU tensors.  There is
no fallback between the two.  ``fused_frontier_ref`` is the gather-based
oracle with the same adapter signature (minus the locality tables).
"""
from __future__ import annotations

import torch

from . import ref
from .fused_frontier import fused_frontier_kernel


def denorm_locality(ell_dgid, g2l_row, owner):
    """Precompute the per-candidate locality tables the fused kernel needs.

    Denormalizes ``g2l_row[dst]`` / ``owner[dst]`` into two extra [Np, W]
    ELL-shaped tables so the kernel never performs a data-dependent gather.
    Call ONCE per evaluator invocation (outside the expansion loop).

    Returns (ell_dlidx [Np, W] int32 — local idx of each candidate dst in
    this partition, -1 if absent/padded; ell_downer [Np, W] int32 — owner
    pid of each candidate dst).
    """
    dsafe = ell_dgid.clamp(0, g2l_row.shape[0] - 1).long()
    ell_dlidx = torch.where(ell_dgid >= 0, g2l_row[dsafe], -1)
    ell_downer = owner[dsafe]
    return ell_dlidx.int(), ell_downer.int()


def _fused_params(rows_b, step_b, m, g2l_row, owner, n_core, plan, n_steps):
    """Pack the per-binding scalars for the fused kernel: pint [EB, 12]
    int32 (columns ``fused_frontier._F_*``), pflt [EB] f32, and the src
    slot of each binding's NEXT plan step."""
    S = plan.src_slot.shape[0]
    V = g2l_row.shape[0]

    s = step_b.clamp(0, S - 1).long()
    active = m & (step_b < n_steps)
    ns = step_b + 1
    islast = ns >= n_steps
    s2 = ns.clamp(0, S - 1).long()
    nsrc = plan.src_slot[s2]            # src slot of the NEXT plan step
    p_dst = plan.dst_slot[s]
    p_closes = plan.closes_cycle[s]
    # next frontier = freshly-bound dst iff the next step expands from the
    # slot this (non-cycle) step binds; otherwise an already-bound vertex
    use_dg = (nsrc == p_dst) & (p_closes == 0)
    fg_sc = rows_b.gather(1, nsrc.long()[:, None])[:, 0]
    fg_safe = fg_sc.clamp(0, V - 1).long()
    fg_lidx = torch.where(fg_sc >= 0, g2l_row[fg_safe], -1)
    fg_owner = owner[fg_safe]

    cols = [plan.edge_label[s], plan.direction[s], plan.dst_label[s],
            plan.dst_value_op[s], p_dst, p_closes, active, islast, use_dg,
            fg_lidx, fg_owner, torch.full_like(step_b, int(n_core))]
    pint = torch.stack([c.int() for c in cols], dim=1)
    pflt = plan.dst_value[s].float()
    return pint, pflt, nsrc


def fused_frontier(rows_b, step_b, lidx_b, m,
                   ell_dst, ell_label, ell_dir,
                   ell_dlab, ell_dval, ell_dgid,
                   ell_dlidx, ell_downer,
                   g2l_row, owner, n_core,
                   plan, n_steps):
    """The fused expand+classify step.  ``ell_dlidx`` / ``ell_downer`` come
    from denorm_locality; ``plan`` is a PlanArrays of tensors on the same
    device.  Returns six [EB, W] tensors: (ok, dg, done, keep, out, dest),
    the masks bool, dg/dest int32."""
    Np = ell_dst.shape[0]
    pint, pflt, _ = _fused_params(rows_b, step_b, m, g2l_row, owner, n_core,
                                  plan, n_steps)
    lidx = lidx_b.clamp(0, Np - 1).int()
    return fused_frontier_kernel(
        lidx, pint, pflt, rows_b.int().contiguous(),
        ell_dst, ell_label, ell_dir, ell_dlab, ell_dval, ell_dgid,
        ell_dlidx, ell_downer)


def fused_frontier_ref(rows_b, step_b, lidx_b, m,
                       ell_dst, ell_label, ell_dir,
                       ell_dlab, ell_dval, ell_dgid,
                       g2l_row, owner, n_core,
                       plan, n_steps):
    """Gather-based oracle with the fused adapter's signature."""
    S = plan.src_slot.shape[0]
    s = step_b.clamp(0, S - 1).long()
    s2 = (step_b + 1).clamp(0, S - 1).long()
    return ref.fused_frontier_ref(
        rows_b, step_b, lidx_b, m,
        ell_dst, ell_label, ell_dir, ell_dlab, ell_dval, ell_dgid,
        g2l_row, owner, n_core,
        plan.edge_label[s], plan.direction[s], plan.dst_label[s],
        plan.dst_value_op[s], plan.dst_value[s], plan.dst_slot[s],
        plan.closes_cycle[s], plan.src_slot[s2], n_steps)
