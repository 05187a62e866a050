"""The language models' device mesh: the JAX package's ``launch/mesh.py``
over ``torch.distributed``.

Single pod : (16, 16)    = ("data", "model")           — 256 ranks
Multi-pod  : (2, 16, 16) = ("pod", "data", "model")    — 512 ranks

One rank is one process on one device.  ``init_world`` joins the group
that ``torch.distributed.run`` launched (NCCL on ``cuda``, gloo on
``cpu``), or makes a one-rank group in this process when nothing launched
it; ``make_test_mesh`` lays the group's ranks out as a ``DeviceMesh``.

Mesh-axis roles, as in the reference:
  pod   — pure data parallelism; params replicated per pod
  data  — batch DP + FSDP (params/optimizer sharded ZeRO-3 style)
  model — tensor parallelism (heads / ff / vocab / experts / lru)

Not to be confused with ``core/mesh.py``, the graph engines' part mesh
(``PartMesh``: MapReduceMP's mappers spread over devices in one process).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.engine import resolve_device


def init_world(device=None, *, init_method: Optional[str] = None) -> torch.device:
    """Join the default process group and return this rank's device.

    Under ``torch.distributed.run`` (``RANK`` and ``WORLD_SIZE`` set) it
    joins the launched group through ``init_method`` (``env://`` by
    default); otherwise it makes a one-rank group in this process (an
    in-memory store, no network).  On ``cuda`` each rank takes the card
    ``LOCAL_RANK``.  A group that already exists is kept.  ``device=None``
    means the card (raises without one)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dev.index or 0))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def close_world() -> None:
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``DeviceMesh`` with the attributes the sharding resolver reads:
    ``axis_names`` and ``shape`` as a dict from axis name to size."""

    device_mesh: DeviceMesh
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.device_mesh.get_local_rank(axis)


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device) -> Mesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call launch.mesh.init_world first")
    n, have = math.prod(shape), dist.get_world_size()
    if n != have:
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has {have}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes)), dev)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — launch one rank "
            f"per device with torch.distributed.run")
    return _mesh(shape, axes, device)


def make_test_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"), device=None) -> Mesh:
    """A mesh over the ranks of the default process group, whose count
    must be the product of ``shape``."""
    return _mesh(tuple(shape), tuple(axes), device)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
