"""The pinned-host tier of the three-level partition cache.

``PartitionStore`` (core/store.py) owns device residency; this module
owns what sits between the device and the disk:

  disk (DiskCatalog shards)  →  host LRU (here)  →  device LRU (store)

Two implementations share one small protocol — ``get(pid)`` returning a
``HostBundle``, ``resident``, ``read_ahead``, ``nbytes``, ``clear``:

``HostArrayTier``  — the in-RAM case (a session built from a live
    ``PartitionedGraph``): every partition's host bundle is always
    resident.  ``read_ahead`` is a no-op.

``HostShardCache`` — the out-of-core case: an LRU of host bundles
    (capacity in partitions or bytes) backed by a ``DiskCatalog``.
    ``read_ahead(pid)`` starts a background thread that pulls the shard
    off disk while the caller keeps evaluating, so the heuristic's
    runner-up partition is in host RAM by the time its turn comes.  A
    later ``get`` joins the thread (a ``read_ahead_hit``) instead of
    paying a demand read on the critical path.

A bundle holds CPU tensors: scalars (pid, n_core) as Python ints, arrays
as tensors.  With ``pin=True`` (a store on CUDA) they are page-locked, so
the store's device copies can run asynchronously: ``HostArrayTier`` pins a
partition at its first ``get``, once; ``HostShardCache`` pins a bundle as
it lands in the tier (on the worker thread for a read-ahead), and evicting
it frees its pinned memory.  With ``pin=False`` the tensors share the
numpy arrays' memory.

Counters (LoadStats, core/store.py) are all kept on the *calling* thread,
so snapshots taken by the engines and the scheduler never race a worker.
A read-ahead reserves its LRU slot when it is issued — counting its disk
read and bytes from the manifest, and evicting to fit, right then — and
its worker only reads, verifies and pins into that slot.  The LRU order
is therefore the one a read-ahead that lands at once would give, however
long the worker takes.

``HostShardCache`` keys are plain pids or a generation view's bundle
tokens ``(pid, generation, seq, node_pad, ell_width, n_nodes)``
(storage/deltas.py ``GenerationView.bundle_token``): two generations of
one partition are two entries, each counted against the capacity.
``get`` and ``read_ahead`` take an optional ``loader`` that builds the
bundle's numpy arrays on a miss (the view's overlay loader: a shard read
re-padded to the view's geometry, or a stale partition rebuilt from the
delta overlay); the tier pins what it returns, on the worker thread for a
read-ahead, exactly as it pins a plain shard read.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch


class HostBundle(NamedTuple):
    """One partition's host-resident staging unit."""

    part: Dict[str, Union[int, torch.Tensor]]   # evaluator input dict
    g2l: torch.Tensor                           # that partition's [V] g2l row
    nbytes: int


def bundle_nbytes(part: Dict[str, np.ndarray], g2l: np.ndarray) -> int:
    return int(sum(np.asarray(v).nbytes for v in part.values())
               + np.asarray(g2l).nbytes)


def host_bundle(part: Dict[str, np.ndarray], g2l: np.ndarray,
                pin: bool) -> HostBundle:
    """A numpy bundle as CPU tensors: page-locked copies with ``pin``,
    views of the arrays without.  Scalars become Python ints."""
    def host(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if pin else t

    return HostBundle(
        part={k: (int(v) if np.ndim(v) == 0 else host(v)) for k, v in part.items()},
        g2l=host(g2l), nbytes=bundle_nbytes(part, g2l))


class HostArrayTier:
    """All partitions in host RAM (a live pg), pinned at first use."""

    def __init__(self, pg, pin: bool = False):
        from ..core.engine import part_to_device_dict
        self._pg = pg
        self._pin = pin
        self._numpy = [part_to_device_dict(p) for p in pg.parts]
        self._bundles: Dict[int, HostBundle] = {}

    @property
    def part_keys(self):
        return self._numpy[0].keys()

    def resident(self, pid: int) -> bool:
        return True

    def get(self, pid: int) -> HostBundle:
        pid = int(pid)
        got = self._bundles.get(pid)
        if got is None:
            got = host_bundle(self._numpy[pid], self._pg.g2l[pid], self._pin)
            self._bundles[pid] = got
        return got

    def read_ahead(self, pid: int) -> bool:
        return False   # nothing to stage: everything is already host-resident

    def nbytes(self, pid: int) -> int:
        return bundle_nbytes(self._numpy[int(pid)], self._pg.g2l[int(pid)])

    def clear(self) -> None:
        pass   # the bundles are the graph itself; nothing to invalidate


class _ReadAhead:
    """An LRU slot reserved by ``read_ahead``; its worker thread sets
    ``bundle`` or ``error`` and nothing else."""

    __slots__ = ("thread", "bundle", "error")

    def __init__(self):
        self.thread: Optional[threading.Thread] = None
        self.bundle: Optional[HostBundle] = None
        self.error: Optional[BaseException] = None


class HostShardCache:
    """Disk-backed host LRU with background read-ahead.

    ``stats`` is the owning store's ``LoadStats``; this tier increments
    ``disk_reads`` / ``bytes_disk`` / ``read_ahead_issued`` /
    ``read_ahead_hits`` / ``bytes_host`` / ``host_evictions`` on it, on
    the calling thread only (see the module docstring).  With no capacity
    the tier holds every shard it has ever read.  ``peak_nbytes`` is the
    most bytes the tier has held at once, read-ahead slots counted at
    their manifest size.
    """

    def __init__(self, catalog, stats,
                 capacity_parts: Optional[int] = None,
                 capacity_bytes: Optional[int] = None,
                 read_ahead: bool = True,
                 pin: bool = False,
                 tracer=None):
        if capacity_parts is not None and capacity_parts < 1:
            raise ValueError(f"host capacity_parts must be >= 1, "
                             f"got {capacity_parts}")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError(f"host capacity_bytes must be >= 1, "
                             f"got {capacity_bytes}")
        self.catalog = catalog
        self.stats = stats
        self.capacity_parts = capacity_parts
        self.capacity_bytes = capacity_bytes
        self.read_ahead_enabled = read_ahead
        self.pin = pin
        if tracer is None:
            from ..obs.trace import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        # key -> a landed bundle, or the slot of a read-ahead no get has
        # consumed yet (in flight or landed)
        self._cache: "OrderedDict[Any, Union[HostBundle, _ReadAhead]]" = OrderedDict()
        # every worker started and not yet joined: clear() joins them all,
        # those of evicted slots included
        self._workers: List[threading.Thread] = []
        self.peak_nbytes = 0

    @property
    def part_keys(self):
        return self.catalog.part_keys

    @staticmethod
    def _norm(key):
        """A plain pid as an int; a bundle token as it is."""
        return int(key) if isinstance(key, (int, np.integer)) else tuple(key)

    @staticmethod
    def _pid_of(key) -> int:
        return int(key if isinstance(key, (int, np.integer)) else key[0])

    def resident(self, key) -> bool:
        """Host-resident NOW — an in-flight read-ahead does not count
        (the store must not try to device-stage a pid whose bytes are
        still on their way: its host get would block on the worker)."""
        got = self._cache.get(self._norm(key))
        if isinstance(got, _ReadAhead):
            return not got.thread.is_alive() and got.error is None
        return got is not None

    def nbytes(self, key) -> int:
        """The manifest's size of the key's partition."""
        return self.catalog.part_nbytes(self._pid_of(key))

    def held_nbytes(self) -> int:
        """Bytes the tier holds now (read-ahead slots at manifest size)."""
        return sum(self.nbytes(k) if isinstance(b, _ReadAhead) else b.nbytes
                   for k, b in self._cache.items())

    def _load(self, key, loader: Optional[Callable[[], Tuple]]) -> HostBundle:
        """Build the bundle: the loader's arrays, or a plain checksum-
        verified shard read; pinned here, on whichever thread runs it."""
        if loader is None:
            part, g2l = self.catalog.read_part(self._pid_of(key))
        else:
            part, g2l = loader()
        return host_bundle(part, g2l, self.pin)

    def get(self, key, loader: Optional[Callable[[], Tuple]] = None) -> HostBundle:
        """The bundle of ``key``; ``loader`` (returning ``(part dict, g2l)``
        numpy arrays) builds it on a miss, default a plain shard read."""
        key = self._norm(key)
        got = self._cache.get(key)
        if isinstance(got, _ReadAhead):
            got.thread.join()
            if got.error is not None:
                del self._cache[key]
                raise got.error   # e.g. StorageFormatError from a corrupt shard
            self._cache[key] = got = got.bundle
            self.stats.read_ahead_hits += 1
        if got is not None:
            self._cache.move_to_end(key)
            self.stats.bytes_host += got.nbytes
            return got
        # demand read: disk on the critical path
        with self.tracer.span("store.disk_read", pid=self._pid_of(key)) as sp:
            self.stats.disk_reads += 1
            bundle = self._load(key, loader)
            self.stats.bytes_disk += bundle.nbytes
            sp.set(nbytes=bundle.nbytes)
        self._insert(key, bundle)
        self.stats.bytes_host += bundle.nbytes
        return bundle

    def read_ahead(self, key, loader: Optional[Callable[[], Tuple]] = None) -> bool:
        """Start building ``key``'s bundle on a background thread (a shard
        read, or ``loader``); returns True when a read was issued (False:
        resident, already in flight, or read-ahead disabled).  The slot is
        reserved in the LRU now, so a read-ahead nobody ever ``get``s is
        still capacity-bounded; a worker failure (corrupt shard, IO error)
        is re-raised by the next ``get(key)`` instead of being swallowed."""
        key = self._norm(key)
        if not self.read_ahead_enabled or key in self._cache:
            return False
        # nbytes comes from the manifest, so no shard I/O happens here
        self.stats.disk_reads += 1
        self.stats.read_ahead_issued += 1
        self.stats.bytes_disk += self.nbytes(key)
        slot = _ReadAhead()
        pid = self._pid_of(key)

        def work() -> None:
            try:
                # the tracer is thread-safe with one timebase, so the read
                # shows in its own thread lane beside the main thread's
                with self.tracer.span("store.read_ahead", pid=pid) as sp:
                    slot.bundle = self._load(key, loader)
                    sp.set(nbytes=slot.bundle.nbytes)
            except BaseException as e:   # surfaced by the next get(key)
                slot.error = e

        slot.thread = threading.Thread(target=work, daemon=True,
                                       name=f"read-ahead-part-{pid}")
        self._workers = [t for t in self._workers if t.is_alive()]
        self._workers.append(slot.thread)
        self._insert(key, slot)
        slot.thread.start()
        return True

    def clear(self) -> None:
        """Drop every host entry and join in-flight read-aheads — the
        invalidation hook ``repartition()`` relies on (stale shards of an
        old layout must never be served)."""
        for t in self._workers:
            t.join()
        self._workers.clear()
        self._cache.clear()

    def _insert(self, key, entry) -> None:
        self._cache[key] = entry
        self._cache.move_to_end(key)
        self._evict(keep=key)
        self.peak_nbytes = max(self.peak_nbytes, self.held_nbytes())

    def _evict(self, keep) -> None:
        def over() -> bool:
            if self.capacity_parts is not None \
                    and len(self._cache) > self.capacity_parts:
                return True
            if self.capacity_bytes is not None \
                    and self.held_nbytes() > self.capacity_bytes:
                return True
            return False

        while over():
            victim = next((k for k in self._cache if k != keep), None)
            if victim is None:
                break   # the just-read shard alone exceeds the budget
            del self._cache[victim]
            self.stats.host_evictions += 1
