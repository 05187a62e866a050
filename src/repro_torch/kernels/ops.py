"""Engine-facing adapters around the port's kernels.

``step_invariants`` packs, once per evaluator call, what the frontier
step reads in every loop (the ELL tables viewed as [P*Np, W], the g2l
rows, each lane's plan as one [L, S, 8] table and its partition, n_core
and n_steps); ``frontier_step`` is the step's device-dispatching wrapper,
which the evaluators call once per loop.  ``frontier_append``
is the appends' wrapper (``append_state`` makes its buffers once per
evaluator call), which the evaluators call after each step launch and
once for their pre-classify.  ``fused_frontier`` and
``frontier_expand`` take the JAX adapters' engine-level signatures (one
batch of binding rows, steps and local indices); ``label_histogram``
checks its mask.  Each reaches its kernel's wrapper: the CUDA kernel on
CUDA tensors, its plain version on CPU tensors.  There is no fallback
between the two.  ``fused_frontier_ref`` and ``frontier_expand_ref`` are
the gather-based oracles with the same signatures.

``denorm_locality``, ``_fused_params`` and ``_next_rows`` are the pieces
of the JAX design that the step's plain version is composed of.  A plan
passed here has fields of shape [S] (one plan for every binding) or
[EB, S] (a plan per binding).

``step_cost`` is the step's cost from its shapes alone (an upper bound at
full occupancy, what the resource profiler stamps on every evaluator
span); ``step_bytes_ops`` counts what one launch's data needs.  Both use
the per-term layout of ``step_terms``.
"""
from __future__ import annotations

import torch

from . import fused_frontier as ff
from . import ref
from .frontier_append import append_state, frontier_append
from .frontier_expand import N_PINT, frontier_expand_kernel
from .fused_frontier import frontier_step, step_outputs
from .label_histogram import label_histogram_kernel

__all__ = ["frontier_step", "step_invariants", "step_outputs", "frontier_append",
           "append_state", "fused_frontier",
           "fused_frontier_ref", "frontier_expand", "frontier_expand_ref",
           "label_histogram", "denorm_locality", "plan_at", "step_cost",
           "step_bytes_ops", "step_terms"]


def plan_at(field, s):
    """``field`` of the plan at each binding's step ``s`` [EB] (long):
    ``field[s]`` for a shared [S] field, a per-row gather for [EB, S]."""
    return field[s] if field.dim() == 1 else field.gather(1, s[:, None])[:, 0]


def denorm_locality(ell_dgid, g2l_row, owner):
    """The TPU design's per-candidate locality tables.

    Denormalizes ``g2l_row[dst]`` / ``owner[dst]`` into two extra [Np, W]
    ELL-shaped tables, because the Pallas kernel can do no data-dependent
    gather.  Only the step's plain version builds them; the CUDA kernel
    looks g2l and owner up directly.
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
    """Pack the TPU kernel's per-binding scalars: pint [EB, 12]
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


def _next_rows(rows_b, step_b, dg, plan):
    """New binding rows [EB, W, Q] and steps [EB, W]: the dst slot bound to
    each candidate unless the step closes a cycle."""
    EB, Q = rows_b.shape
    W = dg.shape[1]
    s = step_b.clamp(0, plan.src_slot.shape[-1] - 1).long()
    p_dst = plan_at(plan.dst_slot, s)
    p_closes = plan_at(plan.closes_cycle, s)
    col = torch.arange(Q, dtype=torch.int32, device=rows_b.device)
    setcol = (col[None, None, :] == p_dst[:, None, None]) & (p_closes[:, None, None] == 0)
    nr = torch.where(setcol, dg[:, :, None], rows_b[:, None, :])
    ns = (step_b[:, None] + 1).expand(EB, W)
    return nr, ns


def step_invariants(tables, g2l, owner, plan, lane_part, n_core, n_steps):
    """Pack and check the frontier step's loop-invariant inputs, once per
    evaluator call.

    ``tables`` are the six ELL tables (ell_dst, ell_label, ell_dir,
    ell_dlab, ell_dval, ell_dgid), [Np, W] or stacked [P, Np, W]; ``g2l``
    is [V] or [P, V]; ``plan``'s step fields are [S] (one lane) or [L, S];
    ``lane_part``, ``n_core`` and ``n_steps`` are ints (for every lane) or
    [L] tensors."""
    Np, W = tables[0].shape[-2:]
    S = plan.src_slot.shape[-1]
    dev = owner.device
    cols = [getattr(plan, f).reshape(-1, S).int() for f in ff.PLAN_INT_FIELDS]
    plan_int = torch.stack(cols + [torch.zeros_like(cols[0])], dim=2)
    plan_val = plan.dst_value.reshape(-1, S).float().contiguous()
    L = plan_int.shape[0]
    vals = (lane_part, n_core, n_steps)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        lane = torch.tensor([[int(v) for v in vals]] * L, dtype=torch.int32,
                            device=dev)
    else:
        lane = torch.stack([torch.as_tensor(v, device=dev).to(torch.int32)
                            .reshape(-1).expand(L) for v in vals], dim=1)
    return ff.make_step_invariants(
        [t.reshape(-1, W) for t in tables], g2l.reshape(-1), owner,
        plan_int.contiguous(), plan_val, lane.contiguous(), Np)


def step_terms(L: int, EB: int, W: int, Q: int, S: int, n_rows: int,
               n_lookups: int) -> dict:
    """Bytes one step launch moves, by term, each input read once and each
    output written once: ``n_rows`` distinct rows of the six 4-byte ELL
    tables, ``n_lookups`` distinct 4-byte owner and g2l entries, the
    binding inputs (sel int64, m bool, lidx, ws and a wr row per selected
    binding; each lane's plan table and lane scalars) and the outputs (ok,
    done, keep, outm bool; dg, dest, ns int32; an nr row per slot)."""
    return {"tables": 6 * n_rows * W * 4,
            "g2l_owner": 4 * n_lookups,
            "binding": L * EB * (8 + 1 + 4 + 4 + 4 * Q) + L * (S * (8 * 4 + 4) + 3 * 4),
            "outputs": L * EB * W * (4 * 1 + 3 * 4 + 4 * Q)}


def step_ops(L: int, EB: int, W: int, Q: int) -> int:
    """Elementwise integer operations of one step launch: about 40 per
    candidate slot (the match, the routing, the lookups' address
    arithmetic) plus 3 per slot and binding column (the injectivity test
    and the new row)."""
    return L * EB * W * (40 + 3 * Q)


def step_cost(L: int, EB: int, W: int, Q: int, S: int, node_pad: int,
              V: int) -> tuple:
    """(operations, bytes) of one frontier-step launch from its shapes
    alone -- L lanes of EB selected bindings over W-wide ELL rows, Q slots
    a row, S plan steps, node_pad rows a partition, V global vertices --
    as an upper bound at full occupancy: every selected binding reads its
    row of the six ELL tables, every candidate and every binding's next
    frontier vertex costs one owner and one g2l lookup, plus the binding
    inputs and every output slot written once.  Never below
    ``step_bytes_ops`` on inputs of these shapes."""
    shape = tuple(int(x) for x in (L, EB, W, Q, S, node_pad, V))
    if min(shape) < 1:
        raise ValueError(f"step shapes must be positive, got {shape}")
    L, EB, W, Q, S, node_pad, V = shape
    cand = L * EB * (W + 1)
    terms = step_terms(L, EB, W, Q, S, n_rows=min(L * EB, L * node_pad),
                       n_lookups=min(cand, V) + min(cand, L * V))
    return step_ops(L, EB, W, Q), sum(terms.values())


def step_bytes_ops(inv, args, got) -> tuple:
    """What one step launch's data needs -- the distinct table rows, g2l
    and owner entries its selection reads, the binding inputs and the
    outputs -- given the invariants ``inv``, the launch's (wr, ws, lidx,
    sel, m) and its outputs ``got``.  Returns (bytes, the bytes by term,
    operations)."""
    wr, ws, lidx, sel, m = args
    L, EB = sel.shape
    W, Q, Np, V = inv.tables[0].shape[1], wr.shape[2], inv.node_pad, inv.owner.shape[0]
    S = inv.plan_int.shape[1]
    lanes = torch.arange(L, device=sel.device)[:, None]
    part = inv.lane[:, 0].long()[:, None]
    rows = lidx[lanes, sel].long().clamp(0, Np - 1) + part * Np
    step = ws[lanes, sel].long()
    pl = inv.plan_int[lanes, step.clamp(0, S - 1)]
    nsrc = inv.plan_int[lanes, (step + 1).clamp(0, S - 1), 0].long()
    use_dg = (nsrc == pl[..., 1]) & (pl[..., 6] == 0)
    fg = wr[lanes, sel].gather(2, nsrc[..., None])[..., 0].long()
    dg = got[1].view(L, EB, W).long()
    dgu = use_dg[..., None].expand_as(dg)
    owner_idx = torch.cat([dg[dgu].clamp(0, V - 1), fg.reshape(-1).clamp(0, V - 1)])
    g2l_idx = torch.cat([(part[..., None] * V + dg)[dgu & (dg >= 0)],
                         (part * V + fg)[fg >= 0]])
    terms = step_terms(L, EB, W, Q, S, n_rows=torch.unique(rows).numel(),
                       n_lookups=torch.unique(owner_idx).numel()
                       + torch.unique(g2l_idx).numel())
    return sum(terms.values()), terms, step_ops(L, EB, W, Q)


def fused_frontier(rows_b, step_b, lidx_b, m,
                   ell_dst, ell_label, ell_dir,
                   ell_dlab, ell_dval, ell_dgid,
                   g2l_row, owner, n_core,
                   plan, n_steps):
    """The fused expand+classify step on one batch of bindings, with the
    JAX adapter's signature less its two locality tables (the step looks
    g2l and owner up itself): the bindings form a one-lane work buffer,
    every row selected.  Returns six [EB, W] tensors: (ok, dg, done, keep,
    out, dest), the masks bool, dg/dest int32."""
    EB, Q = rows_b.shape
    W = ell_dst.shape[1]
    dev = rows_b.device
    inv = step_invariants((ell_dst, ell_label, ell_dir, ell_dlab, ell_dval,
                           ell_dgid), g2l_row, owner, plan, 0, n_core, n_steps)
    out = ff.step_outputs(1, EB, W, Q, dev)
    sel = torch.arange(EB, device=dev)[None]
    one = [x.int().contiguous()[None] for x in (rows_b, step_b, lidx_b)]
    frontier_step(inv, *one, sel, m.contiguous()[None], out)
    return tuple(x.view(EB, W) for x in out[:6])


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
