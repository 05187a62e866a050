"""The part mesh MapReduceMP runs on: the counterpart of the JAX package's
1-D ``("part",)`` device mesh (one device per partition).

A ``PartMesh`` is an ordered tuple of shards.  Each shard is a device and
the contiguous, ascending mapper (partition) ids it holds; together the
shards cover ``0..k-1`` once, in order.  Each shard runs its mappers as
lanes of one frontier-step launch, and the shuffle moves rows between
shards.  Shards may share a device: four one-mapper shards on one card run
every cross-shard step (per-shard buffers and launches, gathered stop
counters, the shuffle as copies between shards), as the JAX package's
tests force four host devices on one CPU.

Not to be confused with ``launch/mesh.py``, the language models' device
mesh (``data`` / ``model`` axes over ``torch.distributed`` ranks).

``make_part_mesh(k)`` spreads the k mappers as evenly as possible over the
visible cards: one card gives one shard of k lanes, four cards at k=4 give
four shards of one.  ``make_part_mesh(k, devices=[...])`` makes one shard
per entry (``devices="cpu"`` is one shard on the CPU).  A bad mesh
raises; there is no CPU fallback.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device]


def normalize_device(d: DeviceLike) -> torch.device:
    """``d`` as a torch.device; a CUDA device without an index names the
    current card, and a CUDA device with no card raises."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available for the part mesh")
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if not 0 <= index < torch.cuda.device_count():
            raise RuntimeError(f"{dev} names no card: "
                               f"{torch.cuda.device_count()} visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"mesh devices must be cuda or cpu, got {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class PartShard:
    """One device and the mapper ids it holds."""

    device: torch.device
    pids: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class PartMesh:
    """Ordered shards whose mapper ids cover ``0..k-1`` once, in order.
    ``shards`` may be given as (device, pids) pairs."""

    shards: Tuple[PartShard, ...]

    def __post_init__(self):
        shards = tuple(PartShard(normalize_device(d), tuple(int(p) for p in pids))
                       for d, pids in ((s.device, s.pids) if isinstance(s, PartShard)
                                       else s for s in self.shards))
        if not shards:
            raise ValueError("a part mesh needs at least one shard")
        if any(not s.pids for s in shards):
            raise ValueError(f"empty shard in {[s.pids for s in shards]}")
        flat = [p for s in shards for p in s.pids]
        if flat != list(range(len(flat))):
            raise ValueError(f"shards must hold the mapper ids 0..k-1 once, in "
                             f"order; got {[s.pids for s in shards]}")
        if len({s.device.type for s in shards}) != 1:
            raise ValueError(f"mixed device types in {[str(s.device) for s in shards]}")
        object.__setattr__(self, "shards", shards)

    @property
    def k(self) -> int:
        return self.shards[-1].pids[-1] + 1

    @property
    def lanes(self) -> Tuple[int, ...]:
        """Each shard's mapper count."""
        return tuple(len(s.pids) for s in self.shards)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The distinct devices, in shard order."""
        return tuple(dict.fromkeys(s.device for s in self.shards))

    @property
    def key(self) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
        """A hashable placement key (the store's cache keys carry it)."""
        return tuple((str(s.device), s.pids) for s in self.shards)

    def peer_access(self) -> Dict[str, bool]:
        """Whether each ordered pair of distinct cards has peer access."""
        cards = [d.index for d in self.devices if d.type == "cuda"]
        return {f"cuda:{a}->cuda:{b}": torch.cuda.can_device_access_peer(a, b)
                for a in cards for b in cards if a != b}

    def __str__(self) -> str:
        return " ".join(f"{s.device}:{list(s.pids)}" for s in self.shards)


def make_part_mesh(k: int, devices: Union[None, DeviceLike,
                                          Sequence[DeviceLike]] = None) -> PartMesh:
    """The k mappers spread as evenly as possible over ``devices`` (one
    shard per entry; repeats allowed), the first shards taking one more
    when k does not divide.  ``devices=None`` means every visible card, at
    most k of them, and raises with none."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available for the part mesh; "
                               "pass devices='cpu' to run on the host")
        devices = [torch.device("cuda", i)
                   for i in range(min(k, torch.cuda.device_count()))]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    n = len(devices)
    if not 1 <= n <= k:
        raise ValueError(f"{n} shards cannot hold k={k} mappers, one or more each")
    shards, lo = [], 0
    for i, d in enumerate(devices):
        size = k // n + (1 if i < k % n else 0)
        shards.append((d, tuple(range(lo, lo + size))))
        lo += size
    return PartMesh(tuple(shards))


def default_part_mesh(k: int, device: Optional[DeviceLike]) -> PartMesh:
    """The mesh an engine uses when given none: every visible card for
    ``"cuda"`` (or None), one shard of k on any other device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        return make_part_mesh(k)
    return make_part_mesh(k, devices=[dev])
