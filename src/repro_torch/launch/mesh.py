"""The language models' device mesh: the JAX package's ``launch/mesh.py``
over ``torch.distributed``.

Single pod : (16, 16)    = ("data", "model")           — 256 ranks
Multi-pod  : (2, 16, 16) = ("pod", "data", "model")    — 512 ranks

One rank is one process on one device.  ``init_world`` joins the group
that ``torch.distributed.run`` launched (NCCL on ``cuda``, gloo on
``cpu``), or makes a one-rank group in this process when nothing launched
it; ``make_test_mesh`` lays the group's ranks out as a ``DeviceMesh``.
``counting_world`` makes this process rank 0 of a group of any size on
torch's ``fake`` backend, whose collectives return at once and move
nothing: the dry run counts one rank's share of a 256- or 512-rank
program on ``meta`` tensors in it.

Ranks lie row-major over the mesh shape (the last axis fastest), as
``init_device_mesh`` lays them out.  Besides one group per axis, a mesh
with both ``pod`` and ``data`` has one group over the two
(``group(("pod", "data"))``, labelled ``"pod+data"``): the batch's rows
and the gradient sums of the leaves ``data`` does not cut span it.

Mesh-axis roles, as in the reference:
  pod   — pure data parallelism; params replicated per pod
  data  — batch DP + FSDP (params/optimizer sharded ZeRO-3 style)
  model — tensor parallelism (heads / ff / vocab / experts / lru)

Not to be confused with ``core/mesh.py``, the graph engines' part mesh
(``PartMesh``: MapReduceMP's mappers spread over devices in one process).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Dict, Iterator, Optional, Tuple, Union

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


@contextlib.contextmanager
def counting_world(n: int) -> Iterator[None]:
    """Within the block this process is rank 0 of an ``n``-rank
    default process group on torch's ``fake`` backend (an in-memory store,
    no peer): a collective returns at once and touches nothing, so a
    program run on ``meta`` tensors issues every collective of that rank
    without a card or a network.  The group is destroyed on exit.  Raises
    where this process already has a group (it belongs to the whole
    process), and ImportError where this torch lacks the backend."""
    if dist.is_initialized():
        raise RuntimeError("this process already has a process group: count a mesh "
                           "in a process of its own")
    # a private module of torch: importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        close_world()


Axes = Union[str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``DeviceMesh`` with the attributes the sharding resolver reads:
    ``axis_names`` and ``shape`` as a dict from axis name to size, and
    the groups of this rank's lines (``groups`` holds those over several
    axes)."""

    device_mesh: DeviceMesh
    device: torch.device
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.device_mesh.shape))

    def group(self, axes: Axes):
        """The process group of this rank's line along ``axes`` (one axis
        name, or a tuple of them in mesh order)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        return self.groups[axes]

    def index(self, axes: Axes) -> int:
        """This rank's coordinate along ``axes``: for several axes its
        row-major index over them (its rank in ``group(axes)``)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
        return idx

    def axis_labels(self) -> Dict[str, str]:
        """{process group name: the axes it spans, joined by "+"}: how a
        collective's group is named in a cost record."""
        out = {}
        for axes in [(a,) for a in self.axis_names] + list(self.groups):
            out.setdefault(self.group(axes).group_name, "+".join(axes))
        return out


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
    mesh = Mesh(init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes)), dev)
    dp = dp_axes(mesh)
    if len(dp) > 1:     # made here, by every rank at once, not inside a program
        mesh.groups[dp] = mesh.device_mesh[dp]._flatten().get_group()
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) with "pod"."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for mesh {shape}, have {have} — launch one rank "
            f"per device with torch.distributed.run (or count one rank's share "
            f"in counting_world)")
    return _mesh(shape, axes, device)


def make_test_mesh(shape: Tuple[int, ...] = (1, 1),
                   axes: Tuple[str, ...] = ("data", "model"), device=None) -> Mesh:
    """A mesh over the ranks of the default process group, whose count
    must be the product of ``shape``."""
    return _mesh(tuple(shape), tuple(axes), device)


def dp_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that carry the batch dimension."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
