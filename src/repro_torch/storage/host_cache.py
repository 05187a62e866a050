"""The pinned-host tier under ``PartitionStore`` (core/store.py).

``HostArrayTier`` is the in-RAM case (a session built from a live
``PartitionedGraph``): every partition's host bundle is always resident.
``read_ahead`` is a no-op.  The store pins these arrays in page-locked
memory on CUDA, so its device copies can run asynchronously.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class HostBundle(NamedTuple):
    """One partition's host-resident staging unit."""

    part: Dict[str, np.ndarray]   # evaluator input dict
    g2l: np.ndarray               # that partition's [V] g2l row
    nbytes: int


def bundle_nbytes(part: Dict[str, np.ndarray], g2l: np.ndarray) -> int:
    return int(sum(np.asarray(v).nbytes for v in part.values())
               + np.asarray(g2l).nbytes)


class HostArrayTier:
    """All partitions pinned in host RAM (built once from a live pg)."""

    def __init__(self, pg):
        from ..core.engine import part_to_device_dict
        self._bundles = [
            HostBundle(part=(d := part_to_device_dict(p)),
                       g2l=pg.g2l[p.pid],
                       nbytes=bundle_nbytes(d, pg.g2l[p.pid]))
            for p in pg.parts]

    @property
    def part_keys(self):
        return self._bundles[0].part.keys()

    def resident(self, pid: int) -> bool:
        return True

    def get(self, pid: int) -> HostBundle:
        return self._bundles[int(pid)]

    def read_ahead(self, pid: int) -> bool:
        return False   # nothing to stage: everything is already host-resident

    def nbytes(self, pid: int) -> int:
        return self._bundles[int(pid)].nbytes

    def clear(self) -> None:
        pass   # pinned bundles are the graph itself; nothing to invalidate
