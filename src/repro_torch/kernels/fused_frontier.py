"""The evaluator loop's frontier step: from the loop's selection to the
expansion, predicate match, routing to done / keep / out and the new
binding rows, for L lanes of EB bindings over their W-wide ELL rows.

Port of ``repro.kernels.fused_frontier`` (the Pallas TPU kernel) and of
what the JAX package computes around it in ``engine._expand_classify``.
The CUDA kernel is ``csrc/fused_frontier.cu``, one launch per evaluator
loop.  ``frontier_step_plain`` is the same function in plain PyTorch,
composed of the JAX design's pieces: the selected-row gathers,
``ops._fused_params``, ``ops.denorm_locality``, ``fused_frontier_plain``
(the TPU kernel's function on its packed ``pint`` layout) and
``ops._next_rows``.  ``frontier_step`` is the wrapper: it runs the plain
version on CPU tensors, launches the CUDA kernel on CUDA tensors, and
raises on anything else.

Loop-invariant inputs, packed and checked once per evaluator call
(``make_step_invariants``; ``ops.step_invariants`` packs them from
engine-level arguments):
  tables    six [P*Np, W] ELL tables — ell_dst, ell_label, ell_dir,
            ell_dlab, ell_dval (f32), ell_dgid — of P stacked partitions
  g2l       [P*V] int32 — each partition's global->local row, flattened
  owner     [V]   int32 — owning partition of each global vertex
  plan_int  [L, S, 8] int32 — each lane's plan, columns ``PLAN_INT_FIELDS``
                              (the eighth is padding)
  plan_val  [L, S] f32 — each lane's ``dst_value``
  lane      [L, 3] int32 — each lane's partition, n_core and n_steps
Per-launch inputs (the evaluator's buffers, read in place):
  wr   [L, N', Q] int32 — work rows, N' >= N; any lane stride, rows contiguous
  ws   [L, N'] int32    — work steps
  lidx [L, N] int32     — local row of each work row's frontier vertex
  sel  [L, EB] int64    — the selected work rows (any lane stride)
  m    [L, EB] bool     — whether each selected row is active
Outputs, written into preallocated buffers (``step_outputs``): ok, done,
keep, outm as [L, EB*W] bool; dg, dest, ns as [L, EB*W] int32; nr as
[L, EB*W, Q] int32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..core.graph import DIR_BACKWARD, DIR_FORWARD, DIR_UNDIRECTED, WILDCARD
from ..core.query import QDIR_ANY, QDIR_IN, QDIR_OUT
from . import build
from .ref import value_pred

# packed int-param column layout of the TPU kernel (pint[:, _F_*])
(_F_EL, _F_DIR, _F_DLAB, _F_DOP, _F_DST, _F_CLOSES, _F_ACTIVE, _F_ISLAST,
 _F_USEDG, _F_FGLIDX, _F_FGOWNER, _F_NCORE) = range(12)
N_FPINT = 12

# the packed plan table plan_int[lane, step, :] (csrc P_* constants)
PLAN_INT_FIELDS = ("src_slot", "dst_slot", "edge_label", "direction",
                   "dst_label", "dst_value_op", "closes_cycle")
N_PLAN_INT = 8
N_LANE = 3     # lane[l] = (partition, n_core, n_steps)

NAME = "fused_frontier"
_TABLE_DTYPES = (torch.int32,) * 4 + (torch.float32, torch.int32)


def fused_frontier_plain(lidx, pint, pflt, rows,
                         ell_dst, ell_label, ell_dir, ell_dlab, ell_dval,
                         ell_dgid, ell_dlidx, ell_downer):
    """The TPU kernel's function on its packed layout, in plain PyTorch:
    lidx [EB] int32 clipped into [0, Np), pint [EB, 12] int32 (columns
    ``_F_*``), pflt [EB] f32, rows [EB, Q] int32 and eight [Np, W] tables
    (the six ELL tables, then ``ops.denorm_locality``'s two).  Returns
    (ok, dg, done, keep, out, dest) as [EB, W], masks bool."""
    li = lidx.long()
    ed, el, edir = ell_dst[li], ell_label[li], ell_dir[li]
    dl, dv, dg = ell_dlab[li], ell_dval[li], ell_dgid[li]
    dlidx, downer = ell_dlidx[li], ell_downer[li]
    col = pint.t()[:, :, None]                       # [12, EB, 1]
    p_el, p_dir, p_dlab, p_dop = col[_F_EL], col[_F_DIR], col[_F_DLAB], col[_F_DOP]
    p_dst, p_closes = col[_F_DST], col[_F_CLOSES]
    active, islast, use_dg = col[_F_ACTIVE], col[_F_ISLAST], col[_F_USEDG]
    fg_lidx, fg_owner, n_core = col[_F_FGLIDX], col[_F_FGOWNER], col[_F_NCORE]

    edge_exists = ed >= 0
    elabel_ok = (p_el == WILDCARD) | (el == p_el)
    dir_ok = ((p_dir == QDIR_ANY)
              | (edir == DIR_UNDIRECTED)
              | ((p_dir == QDIR_OUT) & (edir == DIR_FORWARD))
              | ((p_dir == QDIR_IN) & (edir == DIR_BACKWARD)))
    dlabel_ok = (p_dlab == WILDCARD) | (dl == p_dlab)
    dval_ok = value_pred(p_dop, dv, pflt[:, None])
    inj_ok = ~(dg[:, :, None] == rows[:, None, :]).any(dim=-1)
    bound_dst = rows.gather(1, p_dst.long())
    cyc_ok = (p_closes == 1) & (dg == bound_dst)
    new_ok = (p_closes == 0) & dlabel_ok & dval_ok & inj_ok
    ok = (active == 1) & edge_exists & elabel_ok & dir_ok & (cyc_ok | new_ok)

    lfg = torch.where(use_dg == 1, dlidx, fg_lidx)
    local = (lfg >= 0) & (lfg < n_core)
    done = ok & (islast == 1)
    keep = ok & (islast == 0) & local
    outm = ok & (islast == 0) & ~local
    dest = torch.where(use_dg == 1, downer, fg_owner)
    return ok, dg, done, keep, outm, dest


def check_inputs(lidx, pint, pflt, rows, tables, n_pint, table_dtypes):
    """Raise unless pint-level inputs have the kernel's dtypes and shapes
    (``n_pint`` packed columns, one [Np, W] table per entry of
    ``table_dtypes``), lie on one device and are contiguous."""
    dev = lidx.device
    EB = lidx.shape[0]
    if lidx.dim() != 1 or lidx.dtype != torch.int32:
        raise ValueError(f"lidx must be [EB] int32, got {tuple(lidx.shape)} {lidx.dtype}")
    if tuple(pint.shape) != (EB, n_pint) or pint.dtype != torch.int32:
        raise ValueError(f"pint must be [{EB}, {n_pint}] int32, got "
                         f"{tuple(pint.shape)} {pint.dtype}")
    if tuple(pflt.shape) != (EB,) or pflt.dtype != torch.float32:
        raise ValueError(f"pflt must be [{EB}] float32, got {tuple(pflt.shape)} {pflt.dtype}")
    if rows.dim() != 2 or rows.shape[0] != EB or rows.dtype != torch.int32:
        raise ValueError(f"rows must be [{EB}, Q] int32, got {tuple(rows.shape)} {rows.dtype}")
    if len(tables) != len(table_dtypes):
        raise ValueError(f"need {len(table_dtypes)} ELL tables, got {len(tables)}")
    shape = tuple(tables[0].shape)
    if len(shape) != 2:
        raise ValueError(f"ELL tables must be [Np, W], got {shape}")
    for t, dt in zip(tables, table_dtypes):
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"ELL table must be {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in (lidx, pint, pflt, rows, *tables):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


# ---------------------------------------------------------------------------
# the step: one launch per evaluator loop
# ---------------------------------------------------------------------------

class StepInvariants(NamedTuple):
    """One evaluator call's loop-invariant step inputs, checked once by
    ``make_step_invariants`` (``ptrs`` are their device addresses, in the
    launcher's order)."""

    tables: Tuple[torch.Tensor, ...]
    g2l: torch.Tensor
    owner: torch.Tensor
    plan_int: torch.Tensor
    plan_val: torch.Tensor
    lane: torch.Tensor
    node_pad: int
    ptrs: Tuple[int, ...]


def _expect(t, name, shape, dtype):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")


def make_step_invariants(tables, g2l, owner, plan_int, plan_val, lane,
                         node_pad) -> StepInvariants:
    """Check the loop-invariant inputs (module docstring) and bundle them:
    dtypes and shapes, one device, contiguity, and every lane's partition
    in range.  The last check reads the lane table back to the host."""
    tables = tuple(tables)
    if len(tables) != len(_TABLE_DTYPES):
        raise ValueError(f"need {len(_TABLE_DTYPES)} ELL tables, got {len(tables)}")
    if tables[0].dim() != 2:
        raise ValueError(f"ELL tables must be [P*Np, W], got {tuple(tables[0].shape)}")
    R, W = tables[0].shape
    for i, (t, dt) in enumerate(zip(tables, _TABLE_DTYPES)):
        _expect(t, f"ELL table {i}", (R, W), dt)
    node_pad = int(node_pad)
    if node_pad < 1 or R % node_pad:
        raise ValueError(f"ELL tables have {R} rows, not a multiple of node_pad {node_pad}")
    P = R // node_pad
    if owner.dim() != 1 or owner.shape[0] < 1:
        raise ValueError(f"owner must be [V], got {tuple(owner.shape)}")
    V = owner.shape[0]
    _expect(owner, "owner", (V,), torch.int32)
    _expect(g2l, "g2l", (P * V,), torch.int32)
    if plan_int.dim() != 3 or plan_int.shape[0] < 1 or plan_int.shape[1] < 1:
        raise ValueError(f"plan_int must be [L, S, {N_PLAN_INT}], got "
                         f"{tuple(plan_int.shape)}")
    L, S = plan_int.shape[:2]
    _expect(plan_int, "plan_int", (L, S, N_PLAN_INT), torch.int32)
    _expect(plan_val, "plan_val", (L, S), torch.float32)
    _expect(lane, "lane", (L, N_LANE), torch.int32)
    everything = (*tables, g2l, owner, plan_int, plan_val, lane)
    for t in everything:
        if t.device != owner.device:
            raise ValueError(f"all inputs must be on {owner.device}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    part = lane[:, 0]
    if not bool(((part >= 0) & (part < P)).all()):
        raise ValueError(f"lane partitions must lie in [0, {P})")
    return StepInvariants(tables, g2l, owner, plan_int, plan_val, lane,
                          node_pad, tuple(t.data_ptr() for t in everything))


class StepOutputs(NamedTuple):
    """The step's output buffers, made only by ``step_outputs`` (so their
    dtypes, contiguity and device are right by construction)."""

    ok: torch.Tensor      # [L, EB*W] bool
    dg: torch.Tensor      # [L, EB*W] int32
    done: torch.Tensor    # [L, EB*W] bool
    keep: torch.Tensor    # [L, EB*W] bool
    outm: torch.Tensor    # [L, EB*W] bool
    dest: torch.Tensor    # [L, EB*W] int32
    nr: torch.Tensor      # [L, EB*W, Q] int32
    ns: torch.Tensor      # [L, EB*W] int32


def step_outputs(L: int, EB: int, W: int, Q: int, device) -> StepOutputs:
    """Output buffers for ``frontier_step``, allocated once per evaluator
    call."""
    def make(dtype, *inner):
        return torch.empty((L, EB * W, *inner), dtype=dtype, device=device)
    b, i = torch.bool, torch.int32
    return StepOutputs(make(b), make(i), make(b), make(b), make(b), make(i),
                       make(i, Q), make(i))


def check_step_args(inv: StepInvariants, wr, ws, lidx, sel, m, out) -> None:
    """Raise unless the per-launch inputs fit ``inv`` (module docstring):
    dtypes, shapes, inner contiguity and device.  Lean, since it runs on
    every launch."""
    L = inv.lane.shape[0]
    shape = sel.shape
    if len(shape) != 2 or shape[0] != L or sel.dtype != torch.int64 \
            or sel.stride(1) != 1:
        raise ValueError(f"sel must be [{L}, EB] int64 with unit inner stride, "
                         f"got {tuple(shape)} {sel.dtype}")
    if m.shape != shape or m.dtype != torch.bool or not m.is_contiguous():
        raise ValueError(f"m must be a contiguous {tuple(shape)} bool, got "
                         f"{tuple(m.shape)} {m.dtype}")
    n_rows = lidx.shape
    if len(n_rows) != 2 or n_rows[0] != L or n_rows[1] < 1 \
            or lidx.dtype != torch.int32 or lidx.stride(1) != 1:
        raise ValueError(f"lidx must be [{L}, N] int32 with unit inner stride, "
                         f"got {tuple(n_rows)} {lidx.dtype}")
    N = n_rows[1]
    wshape = ws.shape
    if len(wshape) != 2 or wshape[0] != L or wshape[1] < N \
            or ws.dtype != torch.int32 or ws.stride(1) != 1:
        raise ValueError(f"ws must be [{L}, >={N}] int32 with unit inner stride, "
                         f"got {tuple(wshape)} {ws.dtype}")
    rshape = wr.shape
    if len(rshape) != 3 or rshape[0] != L or rshape[1] < N \
            or wr.dtype != torch.int32 or wr.stride()[1:] != (rshape[2], 1):
        raise ValueError(f"wr must be [{L}, >={N}, Q] int32 with contiguous "
                         f"rows, got {tuple(rshape)} {wr.dtype}")
    if type(out) is not StepOutputs:
        raise ValueError("out must come from step_outputs")
    want = (L, shape[1] * inv.tables[0].shape[1], rshape[2])
    if out.nr.shape != want:
        raise ValueError(f"out is for {tuple(out.nr.shape)} rows, need {want}")
    dev = inv.owner.device
    for t in (wr, ws, lidx, sel, m, out.nr):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got one on {t.device}")


class _LanePlan(NamedTuple):
    """Each binding's plan, fields [EB, S], as ``ops.plan_at`` reads them."""

    src_slot: torch.Tensor
    dst_slot: torch.Tensor
    edge_label: torch.Tensor
    direction: torch.Tensor
    dst_label: torch.Tensor
    dst_value_op: torch.Tensor
    closes_cycle: torch.Tensor
    dst_value: torch.Tensor


def frontier_step_plain(inv: StepInvariants, wr, ws, lidx, sel, m) -> tuple:
    """The kernel's function in plain PyTorch, on any device, composed of
    the JAX design's pieces.  Returns fresh (ok, dg, done, keep, outm,
    dest, nr, ns) shaped as the outputs."""
    from . import ops      # ops imports this module
    L, EB = sel.shape
    R, W = inv.tables[0].shape
    Np, V, Q = inv.node_pad, inv.owner.shape[0], wr.shape[2]
    lanes = torch.arange(L, device=sel.device).repeat_interleave(EB)
    s = sel.reshape(-1)
    rows, step = wr[lanes, s], ws[lanes, s]
    part, n_core, n_steps = inv.lane.long()[lanes].unbind(1)
    li = lidx[lanes, s].clamp(0, Np - 1) + part * Np
    plan = _LanePlan(*inv.plan_int[lanes].unbind(2)[:len(PLAN_INT_FIELDS)],
                     inv.plan_val[lanes])
    pint, pflt, _ = ops._fused_params(rows, step, m.reshape(-1), inv.g2l,
                                      inv.owner, n_core, plan, n_steps,
                                      g2l_off=part * V)
    dlidx, downer = ops.denorm_locality(inv.tables[5].view(R // Np, Np, W),
                                        inv.g2l.view(R // Np, V), inv.owner)
    ok, dg, done, keep, outm, dest = fused_frontier_plain(
        li.int(), pint, pflt, rows, *inv.tables, dlidx.view(R, W),
        downer.view(R, W))
    nr, ns = ops._next_rows(rows, step, dg, plan)
    flat = [x.reshape(L, EB * W) for x in (ok, dg, done, keep, outm, dest, ns)]
    return (*flat[:6], nr.reshape(L, EB * W, Q), flat[6])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load(NAME).fused_frontier_launch
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([P, LL, P, LL, P, LL, I, P, LL, P] + [P] * 11 + [P] * 8
                   + [I] * 7 + [P])
    fn.restype = ctypes.c_int
    return fn


def frontier_step_cuda(inv: StepInvariants, wr, ws, lidx, sel, m,
                       out: StepOutputs) -> StepOutputs:
    """Launch the CUDA kernel on the current stream into ``out``; nothing
    is allocated and nothing synchronises."""
    check_step_args(inv, wr, ws, lidx, sel, m, out)
    L, EB = sel.shape
    # the launcher runs in the current CUDA device: make it the tensors'
    with torch.cuda.device(sel.device):
        stream = torch.cuda.current_stream(sel.device).cuda_stream
        err = _launcher()(
            wr.data_ptr(), wr.stride(0), ws.data_ptr(), ws.stride(0),
            lidx.data_ptr(), lidx.stride(0), lidx.shape[1], sel.data_ptr(),
            sel.stride(0), m.data_ptr(), *inv.ptrs, *[o.data_ptr() for o in out],
            L, EB, inv.tables[0].shape[1], wr.shape[2], inv.plan_int.shape[1],
            inv.node_pad, inv.owner.shape[0], stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return out


def frontier_step(inv: StepInvariants, wr, ws, lidx, sel, m,
                  out: StepOutputs) -> StepOutputs:
    """Device dispatch: CPU tensors run the plain version (copied into
    ``out``), CUDA tensors launch the kernel, anything else raises.
    Returns ``out``."""
    kind = sel.device.type
    if kind == "cpu":
        check_step_args(inv, wr, ws, lidx, sel, m, out)
        for o, v in zip(out, frontier_step_plain(inv, wr, ws, lidx, sel, m)):
            o.copy_(v)
        return out
    if kind == "cuda":
        return frontier_step_cuda(inv, wr, ws, lidx, sel, m, out)
    raise ValueError(f"{NAME} runs on cpu or cuda tensors, not {kind}")
