"""The one-edge frontier expansion match over a batch of EB bindings and
their W-wide ELL rows: the match mask ``ok`` and each candidate's global
id ``dg``.

Port of ``repro.kernels.frontier_expand`` (the Pallas TPU kernel).  The
CUDA kernel is ``csrc/frontier_expand.cu``; ``frontier_expand_plain``
below is the same function in plain PyTorch.  ``frontier_expand_kernel``
is the wrapper: it runs the plain version on CPU tensors, launches the
CUDA kernel on CUDA tensors, and raises on anything else.

Inputs (``ops.frontier_expand`` packs them from engine-level arguments):
  lidx  [EB]    int32 — local row of each binding's frontier vertex,
                        already clipped into [0, Np)
  pint  [EB, 8] int32 — per-binding parameters, columns ``_P_*`` below
  pflt  [EB]    f32   — the step's destination value
  rows  [EB, Q] int32 — current bindings (global ids, -1 unbound)
  six [Np, W] tables  — ell_dst, ell_label, ell_dir, ell_dlab, ell_dval
                        (f32), ell_dgid
Outputs: ok [EB, W] bool, dg [EB, W] int32.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..core.graph import DIR_BACKWARD, DIR_FORWARD, DIR_UNDIRECTED, WILDCARD
from ..core.query import QDIR_ANY, QDIR_IN, QDIR_OUT
from . import build
from .fused_frontier import check_inputs
from .ref import value_pred

# packed int-param column layout (pint[:, _P_*]); _P_ACTIVE already folds
# m & (step < n_steps)
_P_EL, _P_DIR, _P_DLAB, _P_DOP, _P_DST, _P_CLOSES, _P_STEP, _P_ACTIVE = range(8)
N_PINT = 8

NAME = "frontier_expand"
_TABLE_DTYPES = (torch.int32,) * 4 + (torch.float32, torch.int32)


def frontier_expand_plain(lidx, pint, pflt, rows,
                          ell_dst, ell_label, ell_dir, ell_dlab, ell_dval,
                          ell_dgid):
    """The kernel's function in plain PyTorch, on any device."""
    li = lidx.long()
    ed, el, edir = ell_dst[li], ell_label[li], ell_dir[li]
    dl, dv, dg = ell_dlab[li], ell_dval[li], ell_dgid[li]
    col = pint.t()[:, :, None]                       # [8, EB, 1]
    p_el, p_dir, p_dlab, p_dop = col[_P_EL], col[_P_DIR], col[_P_DLAB], col[_P_DOP]
    p_dst, p_closes, active = col[_P_DST], col[_P_CLOSES], col[_P_ACTIVE]

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
    return ok, dg


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load(NAME).frontier_expand_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frontier_expand_cuda(lidx, pint, pflt, rows, *tables):
    """Launch the CUDA kernel on the current stream (outputs allocated
    here; nothing synchronises)."""
    check_inputs(lidx, pint, pflt, rows, tables, N_PINT, _TABLE_DTYPES)
    EB, Q = rows.shape
    W = tables[0].shape[1]
    dev = lidx.device
    ok = torch.empty((EB, W), dtype=torch.bool, device=dev)
    dg = torch.empty((EB, W), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (lidx, pint, pflt, rows, *tables, ok, dg)]
    # the launcher runs in the current CUDA device: make it the tensors'
    with torch.cuda.device(dev):
        err = _launcher()(*ptrs, EB, W, Q, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return ok, dg


def frontier_expand_kernel(lidx, pint, pflt, rows, *tables):
    """Device dispatch: CPU tensors run the plain version, CUDA tensors
    launch the kernel, anything else raises."""
    kind = lidx.device.type
    if kind == "cpu":
        check_inputs(lidx, pint, pflt, rows, tables, N_PINT, _TABLE_DTYPES)
        return frontier_expand_plain(lidx, pint, pflt, rows, *tables)
    if kind == "cuda":
        return frontier_expand_cuda(lidx, pint, pflt, rows, *tables)
    raise ValueError(f"{NAME} runs on cpu or cuda tensors, not {kind}")
