"""The fused frontier step: expansion + predicate match + routing to
done / keep / out, over a batch of EB bindings and their W-wide ELL rows.

Port of ``repro.kernels.fused_frontier`` (the Pallas TPU kernel).  The
CUDA kernel is ``csrc/fused_frontier.cu``; ``fused_frontier_plain`` below
is the same function in plain PyTorch.  ``fused_frontier_kernel`` is the
wrapper: it runs the plain version on CPU tensors, launches the CUDA
kernel on CUDA tensors, and raises on anything else.

Inputs (``ops.fused_frontier`` packs them from engine-level arguments):
  lidx  [EB]     int32 — local row of each binding's frontier vertex,
                         already clipped into [0, Np)
  pint  [EB, 12] int32 — per-binding parameters, columns ``_F_*`` below
  pflt  [EB]     f32   — the step's destination value
  rows  [EB, Q]  int32 — current bindings (global ids, -1 unbound)
  eight [Np, W] tables — ell_dst, ell_label, ell_dir, ell_dlab, ell_dval
                         (f32), ell_dgid, ell_dlidx, ell_downer
Outputs: ok, done, keep, out as [EB, W] bool; dg, dest as [EB, W] int32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.graph import DIR_BACKWARD, DIR_FORWARD, DIR_UNDIRECTED, WILDCARD
from ..core.query import QDIR_ANY, QDIR_IN, QDIR_OUT
from . import build
from .ref import value_pred

# packed int-param column layout (pint[:, _F_*])
(_F_EL, _F_DIR, _F_DLAB, _F_DOP, _F_DST, _F_CLOSES, _F_ACTIVE, _F_ISLAST,
 _F_USEDG, _F_FGLIDX, _F_FGOWNER, _F_NCORE) = range(12)
N_FPINT = 12

NAME = "fused_frontier"
_TABLE_DTYPES = (torch.int32,) * 4 + (torch.float32,) + (torch.int32,) * 3


def fused_frontier_plain(lidx, pint, pflt, rows,
                         ell_dst, ell_label, ell_dir, ell_dlab, ell_dval,
                         ell_dgid, ell_dlidx, ell_downer):
    """The kernel's function in plain PyTorch, on any device."""
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
    """Raise unless the kernel-level inputs have the kernel's dtypes and
    shapes (``n_pint`` packed columns, one [Np, W] table per entry of
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


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load(NAME).fused_frontier_launch
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_frontier_cuda(lidx, pint, pflt, rows, *tables):
    """Launch the CUDA kernel on the current stream (outputs allocated
    here; nothing synchronises)."""
    check_inputs(lidx, pint, pflt, rows, tables, N_FPINT, _TABLE_DTYPES)
    EB, Q = rows.shape
    W = tables[0].shape[1]
    dev = lidx.device
    masks = [torch.empty((EB, W), dtype=torch.bool, device=dev) for _ in range(4)]
    dg = torch.empty((EB, W), dtype=torch.int32, device=dev)
    dest = torch.empty((EB, W), dtype=torch.int32, device=dev)
    ok, done, keep, outm = masks
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = [t.data_ptr() for t in (lidx, pint, pflt, rows, *tables,
                                   ok, dg, done, keep, outm, dest)]
    err = _launcher()(*ptrs, EB, W, Q, stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return ok, dg, done, keep, outm, dest


def fused_frontier_kernel(lidx, pint, pflt, rows, *tables):
    """Device dispatch: CPU tensors run the plain version, CUDA tensors
    launch the kernel, anything else raises."""
    kind = lidx.device.type
    if kind == "cpu":
        check_inputs(lidx, pint, pflt, rows, tables, N_FPINT, _TABLE_DTYPES)
        return fused_frontier_plain(lidx, pint, pflt, rows, *tables)
    if kind == "cuda":
        return fused_frontier_cuda(lidx, pint, pflt, rows, *tables)
    raise ValueError(f"fused_frontier runs on cpu or cuda tensors, not {kind}")
