"""Atomic, resumable checkpoints: the JAX package's
``distributed/checkpoint.py`` for tensors on one host.

Layout (one directory per step), the reference's, so that a directory
written by either package restores in the other:

    <dir>/step_00000420/
        meta.json            — step, each leaf's shape and dtype, extra meta
        host0000.npz         — every leaf, under its path key
        done                 — commit marker

  * writes go to ``step_X.tmp``, which is renamed only after every file
    and the ``done`` marker are written, so a crash mid-save never
    corrupts the latest checkpoint;
  * leaves are keyed by their path in the state tree (dict keys sorted,
    list indices), as the reference's ``_flatten`` writes them:
    ``params/body/0/wq``, ``opt/m/embed``, ``opt/step``;
  * a bf16 leaf is stored as its raw 16 bits in a ``|V2`` record, which is
    what ``np.savez`` writes for a JAX bf16 array, and ``meta.json`` says
    ``"bfloat16"``.  Restore goes by the ``meta.json`` dtype, so a 2-byte
    record (``|V2`` or ``<i2``) comes back as bf16 (the reference hands the
    void array back as it is);
  * data-pipeline state goes into ``meta.json`` (``extra_meta``);
  * ``keep`` bounds disk usage (oldest committed checkpoints pruned).

On a process group (``launch.mesh.init_world``) every rank calls
``save_checkpoint``: a DTensor leaf is gathered whole (``full_tensor()``),
rank 0 writes the one-host layout above, and every rank waits at a
barrier.  ``load_checkpoint(..., shardings=)`` cuts each whole leaf to
this rank's block of its ``NamedSharding`` (``launch.sharding``), so a
checkpoint written on any number of ranks, or by the JAX package,
resumes on any other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..convert import dtype_name


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """(path key, leaf) in the reference's order: dict keys sorted, then
    list and tuple items by index."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [("/".join(prefix), tree)]
    out = []
    for k, v in items:
        out.extend(_flatten(v, prefix + (k,)))
    return out


def _unflatten_like(template, flat: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, flat, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_like(v, flat, prefix + (str(i),))
                              for i, v in enumerate(template))
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key!r}")
    return flat[key]


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A tensor as the array ``np.savez`` gets; bf16 as its bits in ``|V2``."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A stored array as a tensor of its ``meta.json`` dtype."""
    if dtype == "bfloat16":
        bits = np.frombuffer(np.ascontiguousarray(arr).tobytes(), np.int16)
        return torch.from_numpy(bits.reshape(arr.shape).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype)))


def map_tree(tree, other, fn):
    """``fn(leaf, other's leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(v, o, fn) for v, o in zip(tree, other))
    return fn(tree, other)


def _writer() -> bool:
    """Rank 0 of the process group writes (the only process without one)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save_checkpoint(directory: str, step: int, state: Dict[str, Any],
                    extra_meta: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    writer = _writer()
    arrays = {}
    meta_leaves = {}
    for key, leaf in _flatten(state):
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        if writer:
            arrays[key] = _to_numpy(leaf)
            meta_leaves[key] = {"shape": list(leaf.shape), "dtype": dtype_name(leaf.dtype)}
    if writer:
        _write(directory, final, step, arrays, meta_leaves, extra_meta, keep)
    if dist.is_initialized():
        dist.barrier()
    return final


def _write(directory: str, final: str, step: int, arrays, meta_leaves,
           extra_meta, keep: int) -> None:
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "host0000.npz"), **arrays)
    meta = {"step": step, "time": time.time(), "leaves": meta_leaves,
            "n_hosts": 1, **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    with open(os.path.join(tmp, "done"), "w") as f:
        f.write("ok")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    # prune old checkpoints (committed ones only)
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "done")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = latest_steps(directory)
    return steps[-1] if steps else None


def load_checkpoint(directory: str, template, step: Optional[int] = None,
                    device=None, shardings=None) -> Tuple[int, Any, Dict[str, Any]]:
    """Restore ``template``-shaped state as tensors of the stored dtypes:
    on the host, or on ``device`` if given.  ``shardings`` (a tree of
    ``NamedSharding``s of the template's structure) cuts each leaf to
    this rank's block (elastic restore onto another mesh)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    flat: Dict[str, torch.Tensor] = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                for k in z.files:
                    flat[k] = _from_numpy(z[k], meta["leaves"][k]["dtype"])
    state = _unflatten_like(template, flat)
    if shardings is not None:
        state = map_tree(state, shardings, lambda t, s: s.shard(t))
    if device is not None:
        state = map_tree(state, state, lambda t, _: t.to(device))
    return step, state, meta


@dataclasses.dataclass
class CheckpointManager:
    """Save-every-N manager with restart-on-construction semantics."""

    directory: str
    every: int = 100
    keep: int = 3

    def restore_or_none(self, template, device=None, shardings=None):
        if latest_step(self.directory) is None:
            return None
        return load_checkpoint(self.directory, template, device=device,
                               shardings=shardings)

    def due(self, step: int) -> bool:
        """Whether ``maybe_save`` at ``step`` writes."""
        return step % self.every == 0 and step > 0

    def maybe_save(self, step: int, state, extra_meta=None) -> Optional[str]:
        if self.due(step):
            return save_checkpoint(self.directory, step, state,
                                   extra_meta=extra_meta, keep=self.keep)
        return None
