"""Engine-facing adapters around the port's kernels.

``fused_frontier`` and ``frontier_expand`` pack engine-level arguments
(binding rows, steps, the plan, the partition's locality tables) into
their kernels' layouts, and ``label_histogram`` checks its mask; each
calls its device-dispatching wrapper: the CUDA kernel on CUDA tensors,
its plain version on CPU tensors.  There is no fallback between the two.
``fused_frontier_ref`` and ``frontier_expand_ref`` are the gather-based
oracles with the same adapter signatures (minus the locality tables).

A plan passed here has fields of shape [S] (one plan for every binding)
or [EB, S] (a plan per binding, as the lane evaluator packs them).
"""
from __future__ import annotations

import torch

from . import ref
from .frontier_expand import N_PINT, frontier_expand_kernel
from .fused_frontier import fused_frontier_kernel
from .label_histogram import label_histogram_kernel


def plan_at(field, s):
    """``field`` of the plan at each binding's step ``s`` [EB] (long):
    ``field[s]`` for a shared [S] field, a per-row gather for [EB, S]."""
    return field[s] if field.dim() == 1 else field.gather(1, s[:, None])[:, 0]


def denorm_locality(ell_dgid, g2l_row, owner):
    """Precompute the per-candidate locality tables the fused kernel needs.

    Denormalizes ``g2l_row[dst]`` / ``owner[dst]`` into two extra [Np, W]
    ELL-shaped tables so the kernel never performs a data-dependent gather.
    Call ONCE per evaluator invocation (outside the expansion loop).
    Stacked partitions work the same way: ``ell_dgid`` [P, Np, W] with
    ``g2l_row`` [P, V] looks each partition's candidates up in its own row.

    Returns (ell_dlidx [Np, W] int32 — local idx of each candidate dst in
    this partition, -1 if absent/padded; ell_downer [Np, W] int32 — owner
    pid of each candidate dst).
    """
    dsafe = ell_dgid.clamp(0, g2l_row.shape[-1] - 1).long()
    if g2l_row.dim() == 1:
        local = g2l_row[dsafe]
    else:
        local = g2l_row.gather(1, dsafe.reshape(dsafe.shape[0], -1)).view(dsafe.shape)
    ell_dlidx = torch.where(ell_dgid >= 0, local, -1)
    ell_downer = owner[dsafe]
    return ell_dlidx.int(), ell_downer.int()


def _fused_params(rows_b, step_b, m, g2l_row, owner, n_core, plan, n_steps,
                  g2l_off=None):
    """Pack the per-binding scalars for the fused kernel: pint [EB, 12]
    int32 (columns ``fused_frontier._F_*``), pflt [EB] f32, and the src
    slot of each binding's NEXT plan step.

    ``n_steps`` and ``n_core`` are ints or per-binding [EB] tensors.
    ``g2l_off`` [EB] (int64) offsets each binding's lookup into a
    flattened [P*V] ``g2l_row``; None means one [V] row for all."""
    S = plan.src_slot.shape[-1]
    V = owner.shape[0]

    s = step_b.clamp(0, S - 1).long()
    active = m & (step_b < n_steps)
    ns = step_b + 1
    islast = ns >= n_steps
    s2 = ns.clamp(0, S - 1).long()
    nsrc = plan_at(plan.src_slot, s2)   # src slot of the NEXT plan step
    p_dst = plan_at(plan.dst_slot, s)
    p_closes = plan_at(plan.closes_cycle, s)
    # next frontier = freshly-bound dst iff the next step expands from the
    # slot this (non-cycle) step binds; otherwise an already-bound vertex
    use_dg = (nsrc == p_dst) & (p_closes == 0)
    fg_sc = rows_b.gather(1, nsrc.long()[:, None])[:, 0]
    fg_safe = fg_sc.clamp(0, V - 1).long()
    fg_look = fg_safe if g2l_off is None else fg_safe + g2l_off
    fg_lidx = torch.where(fg_sc >= 0, g2l_row[fg_look], -1)
    fg_owner = owner[fg_safe]
    n_core_b = (n_core.expand_as(step_b) if isinstance(n_core, torch.Tensor)
                else torch.full_like(step_b, int(n_core)))

    cols = [plan_at(plan.edge_label, s), plan_at(plan.direction, s),
            plan_at(plan.dst_label, s), plan_at(plan.dst_value_op, s), p_dst,
            p_closes, active, islast, use_dg, fg_lidx, fg_owner, n_core_b]
    pint = torch.stack([c.int() for c in cols], dim=1)
    pflt = plan_at(plan.dst_value, s).float()
    return pint, pflt, nsrc


def fused_frontier(rows_b, step_b, lidx_b, m,
                   ell_dst, ell_label, ell_dir,
                   ell_dlab, ell_dval, ell_dgid,
                   ell_dlidx, ell_downer,
                   g2l_row, owner, n_core,
                   plan, n_steps, g2l_off=None):
    """The fused expand+classify step.  ``ell_dlidx`` / ``ell_downer`` come
    from denorm_locality; ``plan`` is a PlanArrays of tensors on the same
    device; ``g2l_off`` as in ``_fused_params``.  Returns six [EB, W]
    tensors: (ok, dg, done, keep, out, dest), the masks bool, dg/dest
    int32."""
    Np = ell_dst.shape[0]
    pint, pflt, _ = _fused_params(rows_b, step_b, m, g2l_row, owner, n_core,
                                  plan, n_steps, g2l_off)
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


def _expand_params(step_b, m, plan, n_steps):
    """Pack the per-binding scalars for frontier_expand: pint [EB, 8] int32
    (columns ``frontier_expand._P_*``; the active column folds
    ``m & step < n_steps``) and pflt [EB] f32."""
    S = plan.src_slot.shape[-1]
    s = step_b.clamp(0, S - 1).long()
    active = m & (step_b < n_steps)
    cols = [plan_at(plan.edge_label, s), plan_at(plan.direction, s),
            plan_at(plan.dst_label, s), plan_at(plan.dst_value_op, s),
            plan_at(plan.dst_slot, s), plan_at(plan.closes_cycle, s),
            step_b, active]
    assert len(cols) == N_PINT
    pint = torch.stack([c.int() for c in cols], dim=1)
    return pint, plan_at(plan.dst_value, s).float()


def frontier_expand(rows_b, step_b, lidx_b, m,
                    ell_dst, ell_label, ell_dir,
                    ell_dlab, ell_dval, ell_dgid,
                    plan, n_steps):
    """The one-edge match alone, with the JAX adapter's signature: packs
    the per-binding parameters, clips ``lidx`` into [0, Np) and returns
    (ok [EB, W] bool, dg [EB, W] int32)."""
    Np = ell_dst.shape[0]
    pint, pflt = _expand_params(step_b, m, plan, n_steps)
    lidx = lidx_b.clamp(0, Np - 1).int()
    return frontier_expand_kernel(
        lidx, pint, pflt, rows_b.int().contiguous(),
        ell_dst, ell_label, ell_dir, ell_dlab, ell_dval, ell_dgid)


def frontier_expand_ref(rows_b, step_b, lidx_b, m,
                        ell_dst, ell_label, ell_dir,
                        ell_dlab, ell_dval, ell_dgid,
                        plan, n_steps):
    """Gather-based oracle with the frontier_expand adapter's signature."""
    S = plan.src_slot.shape[-1]
    s = step_b.clamp(0, S - 1).long()
    return ref.frontier_expand_ref(
        rows_b, step_b, lidx_b, m,
        ell_dst, ell_label, ell_dir, ell_dlab, ell_dval, ell_dgid,
        *(plan_at(f, s) for f in (plan.edge_label, plan.direction,
                                  plan.dst_label, plan.dst_value_op,
                                  plan.dst_value, plan.dst_slot,
                                  plan.closes_cycle)),
        n_steps)


def label_histogram(node_label, node_value, core_mask, label, value_op, value):
    """Count the core nodes (``core_mask`` int32 0/1) whose label matches
    ``label`` (or ``label`` is WILDCARD) and whose value passes
    (``value_op``, ``value``).  Returns a 0-dim int32 tensor on the inputs'
    device; on the card nothing synchronises."""
    if core_mask.dtype != torch.int32:
        raise ValueError(f"core_mask must be int32 0/1, got {core_mask.dtype}")
    return label_histogram_kernel(node_label, node_value, core_mask, label,
                                  value_op, value)
