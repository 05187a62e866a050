"""The start-node label histogram: how many core nodes match a (label,
value predicate) pair — the one-pass metric that seeds a partition's SNI
entry (paper Sec. 5.1).

Port of ``repro.kernels.label_histogram`` (the Pallas TPU kernel).  The
CUDA kernel is ``csrc/label_histogram.cu``; ``label_histogram_plain``
below is the same function in plain PyTorch.  ``label_histogram_kernel``
is the wrapper: it runs the plain version on CPU tensors, launches the
CUDA kernel on CUDA tensors, and raises on anything else.

One call is one kernel launch.  The kernel's blocks add their counts and
draw tickets on one 64-bit word, and the last block writes the total:
scratch that this module owns, one word per (device, stream), made zero
with ``torch.zeros`` at its stream's first call and left zero by every
call.  A word first made while its stream is being captured into a CUDA
graph puts that zero-fill into the graph, once; the word is then zero
only after the graph has been replayed.  ``use_vector_loads`` picks the
kernel's 16-byte path when every input pointer allows it, else its scalar
path (a contiguous view at an offset is legal input).

Inputs: node_label [Np] int32, node_value [Np] float32, core_mask [Np]
int32 0/1; label and value_op are ints, value a float compared in float32.
A node counts when ``core_mask == 1``, its label equals ``label`` (or
``label`` is WILDCARD) and its value passes the op; NaN fails every op
but OP_NONE.  Output: a 0-dim int32 tensor on the inputs' device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..core.graph import WILDCARD
from . import build
from .ref import value_pred

NAME = "label_histogram"
_DTYPES = (("node_label", torch.int32), ("node_value", torch.float32),
           ("core_mask", torch.int32))
VECTOR_BYTES = 16

# (device index, stream handle) -> the kernel's ticket word, int64 [1]
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def label_histogram_plain(node_label, node_value, core_mask, label, value_op,
                          value):
    """The kernel's function in plain PyTorch, on any device."""
    v = torch.tensor(float(value), dtype=torch.float32, device=node_value.device)
    ok = ((core_mask == 1)
          & ((int(label) == WILDCARD) | (node_label == int(label)))
          & value_pred(int(value_op), node_value, v))
    return ok.sum(dtype=torch.int32)


def _check(node_label, node_value, core_mask):
    n = node_label.shape[0]
    dev = node_label.device
    for (name, dt), t in zip(_DTYPES, (node_label, node_value, core_mask)):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != dt:
            raise ValueError(f"{name} must be [{n}] {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def use_vector_loads(*tensors) -> bool:
    """Whether the kernel may read every input with 16-byte loads: each
    data pointer 16-byte aligned.  Otherwise it reads one node at a time."""
    return all(t.data_ptr() % VECTOR_BYTES == 0 for t in tensors)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = build.load(NAME).label_histogram_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _scratch(dev, stream: int) -> torch.Tensor:
    """The (device, stream)'s ticket word, zeroed once when made."""
    key = (dev.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.zeros(1, dtype=torch.int64, device=dev)
    return buf


def label_histogram_cuda(node_label, node_value, core_mask, label, value_op,
                         value):
    """Launch the CUDA kernel on the current stream; returns the count as
    a 0-dim int32 tensor on the card (nothing synchronises)."""
    _check(node_label, node_value, core_mask)
    dev = node_label.device
    count = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch(dev, stream)
    vec = use_vector_loads(node_label, node_value, core_mask)
    # the launcher runs in the current CUDA device: make it the tensors'
    with torch.cuda.device(dev):
        err = _launcher()(
            node_label.data_ptr(), node_value.data_ptr(), core_mask.data_ptr(),
            node_label.shape[0], int(label), int(value_op), float(value),
            count.data_ptr(), scratch.data_ptr(), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{NAME} launch failed: cudaError {err}")
    build.LAUNCHES[NAME] += 1
    return count


def label_histogram_kernel(node_label, node_value, core_mask, label, value_op,
                           value):
    """Device dispatch: CPU tensors run the plain version, CUDA tensors
    launch the kernel, anything else raises."""
    kind = node_label.device.type
    if kind == "cpu":
        _check(node_label, node_value, core_mask)
        return label_histogram_plain(node_label, node_value, core_mask, label,
                                     value_op, value)
    if kind == "cuda":
        return label_histogram_cuda(node_label, node_value, core_mask, label,
                                    value_op, value)
    raise ValueError(f"{NAME} runs on cpu or cuda tensors, not {kind}")
