"""The evaluator's masked appends: per lane, the candidates whose ``done``
flag is set go to the completed buffer, those whose ``outm`` flag is set to
the outgoing buffer (with their step and destination), and those whose
``keep`` flag is set into the lowest free slots of the work buffer.

No TPU kernel does this: the JAX package builds the appends from
``cumsum`` and scatter in ``repro.core.engine``.  The CUDA kernel is
``csrc/frontier_append.cu``, one launch per append (the evaluator's
pre-classify once a call, then one a loop); it ranks the flags and moves
only the rows that land.  ``frontier_append_plain`` is the cumsum and
scatter form, which every candidate's row passes through (those that do
not land to each buffer's trash row).  ``frontier_append`` is the
wrapper: it runs the plain version on CPU tensors, launches the CUDA
kernel on CUDA tensors, and raises on anything else.

The buffers (``append_state``, made once per evaluator call):
  comp_rows [L, cap + 1, Q] int32, comp_n [L] int32 — completed rows
  out_rows  [L, cap + 1, Q] int32, out_step / out_dest [L, cap + 1] int32,
            out_n [L] int32 — outgoing rows
  overflow  [L] bool — a total passed cap, or more keep rows than free slots
  landed    [L] int64 — rows the appends wrote (completed + outgoing + kept)
  scratch   int64 — the kernel's epoch, tile statuses and tile counts,
            zero when made; laid out by its size alone, so appends of
            any N up to ``n_max`` share it
The last row of each lane's buffers is its trash row, which only the plain
version writes.  Per append (``frontier_append``):
  rows [L, N, Q] int32 (rows contiguous, any lane stride), step and dest
  [L, N] int32 (unit inner stride) — the candidates
  done, outm [L, N] bool, contiguous — which land where; keep [L, N] bool
  or None
  work — (wr [L, WT + 1, Q], ws [L, WT + 1] int32, wv [L, WT + 1] bool),
  contiguous, the work buffers with their trash row; with keep only
  free [L, min(N, WT)] int64 (unit inner stride) — each lane's work slots,
  free ones first, lowest index first (a stable sort of ``~wv``); with
  keep only
Rows past ``cap`` (or past the free list) are dropped; ``comp_n`` and
``out_n`` are clamped at ``cap``; nothing synchronises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import build

NAME = "frontier_append"
TILE = 8192          # candidates a block ranks (csrc TILE)
VECTOR_BYTES = 16


class AppendState(NamedTuple):
    """One evaluator call's append buffers, made only by ``append_state``."""

    comp_rows: torch.Tensor   # [L, cap + 1, Q] int32
    comp_n: torch.Tensor      # [L] int32
    out_rows: torch.Tensor    # [L, cap + 1, Q] int32
    out_step: torch.Tensor    # [L, cap + 1] int32
    out_dest: torch.Tensor    # [L, cap + 1] int32
    out_n: torch.Tensor       # [L] int32
    overflow: torch.Tensor    # [L] bool
    landed: torch.Tensor      # [L] int64
    scratch: torch.Tensor     # [2 + 4 * L * tiles] int64


def scratch_words(L: int, n: int) -> int:
    """The kernel's scratch for L lanes of up to ``n`` candidates: the
    epoch and ticket words, then one status word and six 32-bit counts for
    each of a lane's most tiles (the kernel reads that most back from the
    size)."""
    return 2 + 4 * L * -(-n // TILE)


def append_state(L: int, cap: int, Q: int, n_max: int, device) -> AppendState:
    """Empty buffers for appends of up to ``n_max`` candidates a lane:
    rows -1, steps 0, destinations -1, counts 0."""
    i = torch.int32

    def full(shape, value, dtype=i):
        return torch.full(shape, value, dtype=dtype, device=device)
    return AppendState(full((L, cap + 1, Q), -1), full((L,), 0),
                       full((L, cap + 1, Q), -1), full((L, cap + 1), 0),
                       full((L, cap + 1), -1), full((L,), 0),
                       full((L,), False, torch.bool), full((L,), 0, torch.int64),
                       full((scratch_words(L, n_max),), 0, torch.int64))


def _append_plain(buf_rows, buf_aux, buf_n, rows, aux_rows, mask, overflow):
    """Per-lane masked append into [L, cap + 1, ...] buffers whose last
    row is each lane's trash row."""
    L, _, Q = buf_rows.shape
    lanes = torch.arange(L, device=rows.device)
    cap = buf_rows.shape[1] - 1
    cnt = torch.cumsum(mask, 1) - 1
    tgt = buf_n[:, None] + cnt
    tgt = torch.where(mask & (tgt < cap), tgt, cap)
    flat = (tgt + lanes[:, None] * (cap + 1)).reshape(-1)
    buf_rows.view(-1, Q)[flat] = rows.reshape(-1, Q)
    for b, a in zip(buf_aux, aux_rows):
        b.view(-1)[flat] = a.reshape(-1)
    total = buf_n + mask.sum(1)
    return total.clamp(max=cap), overflow | (total > cap)


def frontier_append_plain(st: AppendState, rows, step, dest, done, outm,
                          keep=None, work=None, free=None) -> None:
    """The appends in plain PyTorch, on any device: the cumsum and scatter
    form, every candidate's row written (to the trash row if it does not
    land).  Updates ``st`` (and ``work``) in place."""
    L, Q = rows.shape[0], rows.shape[2]
    comp0, out0 = st.comp_n.long(), st.out_n.long()
    comp_n, overflow = _append_plain(st.comp_rows, (), comp0, rows, (), done,
                                     st.overflow)
    out_n, overflow = _append_plain(st.out_rows, (st.out_step, st.out_dest),
                                    out0, rows, (step, dest), outm, overflow)
    landed = comp_n - comp0 + out_n - out0
    if keep is not None:
        # keep-rows go into each lane's lowest free work slots
        wr_full, ws_full, wv_full = work
        WT = wv_full.shape[1] - 1
        kfree = free.shape[1]
        wv = wv_full[:, :WT]
        overflow = overflow | (keep.sum(1) > (~wv).sum(1))
        pos = torch.cumsum(keep, 1) - 1
        tgt = torch.where(keep & (pos < kfree),
                          free.gather(1, pos.clamp(0, kfree - 1)), WT)
        work_off = (torch.arange(L, device=rows.device) * (WT + 1))[:, None]
        flat = (tgt + work_off).reshape(-1)
        wr_full.view(-1, Q)[flat] = rows.reshape(-1, Q)
        ws_full.view(-1)[flat] = step.reshape(-1)
        wv_full.view(-1)[flat] = True
        landed = landed + keep.sum(1).clamp(max=kfree)
    st.comp_n.copy_(comp_n)
    st.out_n.copy_(out_n)
    st.overflow.copy_(overflow)
    st.landed.add_(landed)


def _expect(t, name, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.device != device:
        raise ValueError(f"all inputs must be on {device}, got {name} on {t.device}")


def check_append_args(st: AppendState, rows, step, dest, done, outm, keep,
                      work, free) -> None:
    """Raise unless the inputs fit ``st`` (module docstring): dtypes,
    shapes, strides and one device.  Lean, since it runs on every append."""
    if type(st) is not AppendState:
        raise ValueError("st must come from append_state")
    L, cap1, Q = st.comp_rows.shape
    dev = st.comp_rows.device
    if done.dim() != 2 or done.shape[0] != L:
        raise ValueError(f"done must be [{L}, N], got {tuple(done.shape)}")
    N = done.shape[1]
    _expect(rows, "rows", (L, N, Q), torch.int32, dev)
    if rows.stride()[1:] != (Q, 1):
        raise ValueError("rows must have contiguous rows")
    for t, name in ((step, "step"), (dest, "dest")):
        _expect(t, name, (L, N), torch.int32, dev)
        if t.stride(1) != 1:
            raise ValueError(f"{name} must have unit inner stride")
    masks = (done, outm) if keep is None else (done, outm, keep)
    for t in masks:
        _expect(t, "mask", (L, N), torch.bool, dev)
        if not t.is_contiguous():
            raise ValueError("masks must be contiguous")
    if (keep is None) != (work is None) or (keep is None) != (free is None):
        raise ValueError("keep, work and free come together")
    if scratch_words(L, N) > st.scratch.numel():
        raise ValueError(f"st holds appends of fewer than {N} candidates a lane")
    if keep is None:
        return
    wr, ws, wv = work
    WT1 = wv.shape[1] if wv.dim() == 2 else 0
    for t, name, shape, dtype in ((wr, "wr", (L, WT1, Q), torch.int32),
                                  (ws, "ws", (L, WT1), torch.int32),
                                  (wv, "wv", (L, WT1), torch.bool)):
        _expect(t, name, shape, dtype, dev)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    # the kernel's overflow test reads kfree as min(N, WT)
    _expect(free, "free", (L, min(N, WT1 - 1)), torch.int64, dev)
    if free.stride(1) != 1:
        raise ValueError("free must have unit inner stride")


def _aligned(t, *strides) -> bool:
    return (t.data_ptr() % VECTOR_BYTES == 0
            and all(s * t.element_size() % VECTOR_BYTES == 0 for s in strides))


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load(NAME).frontier_append_launch
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([P, LL] * 6 + [P] * 6 + [LL] + [P] * 5 + [LL] + [P, LL, LL]
                   + [P, LL, LL, I, I, LL, I, I, P])
    fn.restype = ctypes.c_int
    return fn


def frontier_append_cuda(st: AppendState, rows, step, dest, done, outm,
                         keep=None, work=None, free=None) -> None:
    """Launch the CUDA kernel on the current stream; nothing is allocated
    and nothing synchronises."""
    check_append_args(st, rows, step, dest, done, outm, keep, work, free)
    L, N = done.shape
    Q = rows.shape[2]
    masks = (done, outm) if keep is None else (done, outm, keep)
    mask_vec = all(_aligned(m, m.stride(0)) for m in masks)
    row_bufs = [(rows, rows.stride(0)), (st.comp_rows,), (st.out_rows,)]
    if keep is not None:
        row_bufs.append((work[0],))
    row_vec = Q % 4 == 0 and all(_aligned(t, *s) for t, *s in row_bufs)
    null = (None, 0)
    kp, kls = null if keep is None else (keep.data_ptr(), keep.stride(0))
    wr, ws, wv = (None, None, None) if work is None else (t.data_ptr() for t in work)
    work_ls = 0 if work is None else work[2].shape[1]
    fp, fls, kfree = ((None, 0, 0) if free is None
                      else (free.data_ptr(), free.stride(0), free.shape[1]))
    dev = done.device
    # the launcher runs in the current CUDA device: make it the tensors'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _launcher()(
            done.data_ptr(), done.stride(0), outm.data_ptr(), outm.stride(0),
            kp, kls, rows.data_ptr(), rows.stride(0), step.data_ptr(),
            step.stride(0), dest.data_ptr(), dest.stride(0),
            st.comp_rows.data_ptr(), st.comp_n.data_ptr(), st.out_rows.data_ptr(),
            st.out_step.data_ptr(), st.out_dest.data_ptr(), st.out_n.data_ptr(),
            st.out_step.shape[1], st.overflow.data_ptr(), st.landed.data_ptr(),
            wr, ws, wv, work_ls, fp, fls, kfree, st.scratch.data_ptr(),
            st.scratch.numel(), N, L, Q, st.out_step.shape[1] - 1,
            int(mask_vec), int(row_vec), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    build.LAUNCHES[NAME] += 1


def frontier_append(st: AppendState, rows, step, dest, done, outm,
                    keep: Optional[torch.Tensor] = None,
                    work: Optional[Tuple[torch.Tensor, ...]] = None,
                    free: Optional[torch.Tensor] = None) -> None:
    """Device dispatch: CPU tensors run the plain version, CUDA tensors
    launch the kernel, anything else raises.  Updates ``st`` (and
    ``work``) in place."""
    kind = done.device.type
    if kind == "cpu":
        check_append_args(st, rows, step, dest, done, outm, keep, work, free)
        frontier_append_plain(st, rows, step, dest, done, outm, keep, work, free)
        return
    if kind == "cuda":
        frontier_append_cuda(st, rows, step, dest, done, outm, keep, work, free)
        return
    raise ValueError(f"{NAME} runs on cpu or cuda tensors, not {kind}")
