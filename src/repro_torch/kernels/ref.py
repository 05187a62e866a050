"""Plain PyTorch oracles for the frontier step and the label histogram
(the correctness references, written the way the JAX package's
``kernels/ref.py`` writes them: gathers over the ELL tables and the
partition's g2l/owner rows).

The CPU tests hold these against the JAX package's oracles; the kernels'
plain versions (kernels/fused_frontier.py, kernels/frontier_expand.py,
kernels/label_histogram.py) are held against them.
"""
from __future__ import annotations

import torch

from ..core.graph import DIR_BACKWARD, DIR_FORWARD, DIR_UNDIRECTED, WILDCARD
from ..core.query import (OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, OP_NE, OP_NONE,
                          QDIR_ANY, QDIR_IN, QDIR_OUT)


def value_pred(op, values, v):
    """Branchless value-predicate evaluation on tensors (NaN fails all
    ops).  ``values`` and ``v`` compare in float32."""
    finite = values == values
    res = (
        ((op == OP_EQ) & (values == v))
        | ((op == OP_NE) & (values != v))
        | ((op == OP_LT) & (values < v))
        | ((op == OP_LE) & (values <= v))
        | ((op == OP_GT) & (values > v))
        | ((op == OP_GE) & (values >= v))
    )
    return (op == OP_NONE) | (finite & res)


def frontier_expand_ref(rows_b, step_b, lidx_b, m,
                        ell_dst, ell_label, ell_dir,
                        ell_dlab, ell_dval, ell_dgid,
                        p_el, p_dir, p_dlab, p_dop, p_dval, p_dst, p_closes,
                        n_steps):
    """One-edge expansion match over an [EB, W] candidate tile.

    Args (EB bindings, W = ELL width, Q = binding row width):
      rows_b   [EB, Q] int32  — current bindings (global vertex ids, -1 unbound)
      step_b   [EB]    int32  — next plan step per row
      lidx_b   [EB]    int32  — local index of the frontier vertex
      m        [EB]    bool   — row-active mask
      ell_*    [Np, W]        — ELLPACK adjacency + denormalized dst attrs
      p_*      [EB]           — per-row plan-step parameters (pre-gathered)
      n_steps  int

    Returns: ok [EB, W] bool match mask, dg [EB, W] int32 dst global ids.
    """
    lsafe = lidx_b.clamp(0, ell_dst.shape[0] - 1).long()
    ed = ell_dst[lsafe]
    el = ell_label[lsafe]
    edir = ell_dir[lsafe]
    dl = ell_dlab[lsafe]
    dv = ell_dval[lsafe]
    dg = ell_dgid[lsafe]

    p_el, p_dir, p_dlab = p_el[:, None], p_dir[:, None], p_dlab[:, None]
    edge_exists = ed >= 0
    elabel_ok = (p_el == WILDCARD) | (el == p_el)
    dir_ok = ((p_dir == QDIR_ANY)
              | (edir == DIR_UNDIRECTED)
              | ((p_dir == QDIR_OUT) & (edir == DIR_FORWARD))
              | ((p_dir == QDIR_IN) & (edir == DIR_BACKWARD)))
    dlabel_ok = (p_dlab == WILDCARD) | (dl == p_dlab)
    dval_ok = value_pred(p_dop[:, None], dv, p_dval[:, None].float())
    inj_ok = ~(rows_b[:, None, :] == dg[:, :, None]).any(dim=-1)
    bound_dst = rows_b.gather(1, p_dst[:, None].long())
    cyc_ok = (p_closes[:, None] == 1) & (bound_dst == dg)
    new_ok = (p_closes[:, None] == 0) & dlabel_ok & dval_ok & inj_ok
    ok = (m[:, None] & (step_b[:, None] < n_steps)
          & edge_exists & elabel_ok & dir_ok & (cyc_ok | new_ok))
    return ok, dg


def fused_frontier_ref(rows_b, step_b, lidx_b, m,
                       ell_dst, ell_label, ell_dir,
                       ell_dlab, ell_dval, ell_dgid,
                       g2l_row, owner, n_core,
                       p_el, p_dir, p_dlab, p_dop, p_dval, p_dst, p_closes,
                       nsrc, n_steps):
    """Fused expansion + answer-emission classification.  Extends
    frontier_expand_ref with the routing decision the engine loop makes
    for every produced row.

    Extra args over frontier_expand_ref:
      g2l_row [V]  int32 — global->local index for THIS partition (-1 absent)
      owner   [V]  int32 — owning partition id per global vertex
      n_core  int        — #core nodes of this partition
      nsrc    [EB] int32 — src slot of the NEXT plan step (pre-gathered)

    Returns six [EB, W] tensors: ok/done/keep/out bool, dg/dest int32, as
      ok   — candidate matched this step's predicates
      done — matched and the plan is complete (append to FAA)
      keep — matched, continues, next frontier is core-local (work buffer)
      out  — matched, continues, next frontier owned elsewhere
      dest — owner pid of the next frontier vertex (meaningful where out)
    """
    ok, dg = frontier_expand_ref(
        rows_b, step_b, lidx_b, m,
        ell_dst, ell_label, ell_dir, ell_dlab, ell_dval, ell_dgid,
        p_el, p_dir, p_dlab, p_dop, p_dval, p_dst, p_closes, n_steps)

    EB, Q = rows_b.shape
    W = ok.shape[1]
    col = torch.arange(Q, dtype=torch.int32, device=rows_b.device)
    setcol = ((col[None, None, :] == p_dst[:, None, None])
              & (p_closes[:, None, None] == 0))
    nr = torch.where(setcol, dg[:, :, None], rows_b[:, None, :])  # [EB, W, Q]
    ns = (step_b[:, None] + 1).expand(EB, W)

    done = ok & (ns >= n_steps)
    fg = nr.gather(2, nsrc.long()[:, None, None].expand(EB, W, 1))[:, :, 0]
    fg_safe = fg.clamp(0, g2l_row.shape[0] - 1).long()
    l2 = g2l_row[fg_safe]
    local = (l2 >= 0) & (l2 < n_core) & (fg >= 0)
    keep = ok & ~done & local
    outm = ok & ~done & ~local
    dest = owner[fg_safe]
    return ok, dg, done, keep, outm, dest


def label_histogram_ref(node_label, node_value, n_core_mask,
                        label, value_op, value):
    """#nodes matching (label, value predicate) among core nodes.

    node_label [Np] int32, node_value [Np] f32, n_core_mask [Np] bool.
    Returns a 0-dim int32 count.
    """
    ok = n_core_mask & ((label == WILDCARD) | (node_label == label))
    ok = ok & value_pred(value_op, node_value,
                         torch.tensor(float(value), dtype=torch.float32))
    return ok.sum(dtype=torch.int32)
