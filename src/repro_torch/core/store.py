"""PartitionStore — explicit partition residency on one device.

The paper's central cost model is the partition *load* sequence: OPAT pays
one load per heuristic pick.  The store makes residency a first-class
object, with the same counters as the JAX package's store:

  cold load  — the requested entry was not device-resident; the store
               copies it to the device on the caller's critical path (a
               cache *miss*).
  warm load  — the entry was already device-resident (from an earlier get
               or a prefetch); the caller reuses its tensors (a *hit*).
  prefetch   — ``prefetch(pid)`` stages an entry *off* the critical path.
               A later ``get`` of it is a warm load and also counts as a
               ``prefetch_hit``.

Eviction is LRU with an optional capacity in partitions
(``capacity_parts``) or bytes (``capacity_bytes``); pinned entries are
never evicted (``pin`` / ``unpin`` / ``pinned``).  A traced store records
each eviction as a ``store.evict`` event (``pid``, ``nbytes``, and
``unread``: a prefetched entry no ``get`` ever read).  The store's
budget bounds what its cache holds; a caller that keeps an evicted
entry keeps its device memory too, so the loops drop each round's entry
once the round is done.

On CUDA the host tier's bundles sit in page-locked memory
(storage/host_cache.py).  A cold ``get`` copies on the current
stream.  ``prefetch`` copies with ``non_blocking=True`` on a side stream
and records an event; the first ``get`` of that entry makes the current
stream wait on the event and calls ``record_stream`` on every tensor, so
the evaluator never reads a partition before its copy lands and the
caching allocator never reuses its memory while the current stream may
still read it.  On CPU the "device" tensors share the host arrays' memory.

Entries come in two shapes, as in the JAX package's store: one partition
(``get(pid)``, OPAT's unit, keyed by the int pid) and a *stacked* bundle
over an ordered tuple of pids (``get_stacked(pids)``, TraditionalMP's
per-iteration unit, keyed by the tuple — order and duplicates included).
A stacked bundle of n partitions costs n against ``capacity_parts``, and
at most ``max_stacked_entries`` distinct bundles stay resident (LRU),
since each one duplicates its partitions' buffers.  A stacked bundle is
staged without a stacked host copy: each partition's page-locked host
tensors copy straight into their slice of the device tensor.

``get_stacked(pids, device=...)`` places a bundle, the counterpart of the
JAX package's ``sharding=``: on one device, or over a ``PartMesh``
(core/mesh.py), where each shard stages its own [L_s, ...] stack on its
device (``StoreEntry.shards``; two shards on one device share nothing).
It is one load, counted as the JAX package counts one sharded stacked
load: cold the first time, warm after, the bundle's bytes.  The placement
is part of the cache key, so a mesh change never serves a stale entry.

``release(key)`` is the scheduler's retirement hook: a counted ``drop``.

Out of core: pass ``backing=DiskCatalog`` (storage/format.py) and the
store becomes the top of a THREE-tier cache — every device miss goes
through a pinned-host LRU (``host_cache_parts`` / ``host_cache_bytes``,
storage/host_cache.py), a host miss to a disk shard read (``disk_reads``);
``prefetch(pid)`` of a partition that is not host-resident issues a
background-thread *read-ahead* and no device copy, so the heuristic's
runner-up overlaps the current partition's evaluation at the disk tier as
it does at the device tier (``read_ahead_issued`` / ``read_ahead_hits``).
Device copies are issued on the calling thread only.  Without a backing
the host tier is the whole graph in RAM.

Generation views (mutable graph directories, storage/deltas.py):
``with store.viewing(view): ...`` resolves every load in the block, on
the calling thread, against that pinned generation.  Cache keys in both
tiers become the view's bundle tokens ``(pid, generation, seq, node_pad,
ell_width, n_nodes)``, so two generations of one partition coexist (each
counted against the capacity) and a view can never be served another's
bundle; a host miss builds the bundle through the view's overlay loader
(a shard read re-padded to the view's geometry, or a stale partition
rebuilt from its pending deltas, counted as ``delta_overlays`` on the
calling thread before the load).  ``owner`` is then the view's [V]
table, copied to each device once per (generation, seq) and kept in an
LRU of four, so the owner table, the g2l rows and the graph a kernel
reads always come from one view (``owner_on(device)`` for a mesh's
devices).  Pins, ``drop``, ``release`` and
``contains`` name the plain pid (or pid tuple) and cover every
generation's staging of it.  With no view the keys are the plain pids.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..obs.profile import NULL_PROFILER
from ..obs.trace import NULL_TRACER
from ..storage.host_cache import HostArrayTier, HostShardCache
from .engine import resolve_device
from .graph import PartitionedGraph
from .mesh import PartMesh, normalize_device


@dataclasses.dataclass
class LoadStats:
    """Residency counters; deltas of two snapshots describe one run.  The
    fields match the JAX package's ``LoadStats``; the out-of-core ones
    stay zero for a store with no backing."""

    hits: int = 0                # warm loads (entry already device-resident)
    misses: int = 0              # cold loads (copy on the critical path)
    evictions: int = 0           # LRU entries dropped to fit capacity
    prefetch_issued: int = 0     # prefetch() calls that actually staged
    prefetch_hits: int = 0       # gets served by a previously prefetched entry
    bytes_cold: int = 0          # bytes transferred by cold (demand) loads
    bytes_prefetched: int = 0    # bytes transferred off the critical path
    released: int = 0            # entries release()d by the scheduler
    disk_reads: int = 0          # shard reads, demand + read-ahead
    read_ahead_issued: int = 0   # background-thread shard reads started
    read_ahead_hits: int = 0     # host gets served by a read-ahead
    bytes_disk: int = 0          # bytes read off disk (demand + read-ahead)
    bytes_host: int = 0          # bytes served out of the host LRU tier
    host_evictions: int = 0      # host-LRU entries dropped to fit capacity
    delta_overlays: int = 0      # bundles rebuilt from a view's pending
                                 # delta overlay (stale pids)

    @property
    def warm_loads(self) -> int:
        return self.hits

    @property
    def cold_loads(self) -> int:
        return self.misses

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    def copy(self) -> "LoadStats":
        return dataclasses.replace(self)

    def __sub__(self, other: "LoadStats") -> "LoadStats":
        return LoadStats(**{f.name: getattr(self, f.name) - getattr(other, f.name)
                            for f in dataclasses.fields(self)})

    def __add__(self, other: "LoadStats") -> "LoadStats":
        return LoadStats(**{f.name: getattr(self, f.name) + getattr(other, f.name)
                            for f in dataclasses.fields(self)})

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["warm_loads"] = self.warm_loads
        d["cold_loads"] = self.cold_loads
        d["hit_rate"] = self.hit_rate
        return d


StoreKey = Union[int, Tuple[int, ...]]


@dataclasses.dataclass
class StoreEntry:
    """One device-resident unit: evaluator inputs + the matching g2l
    row(s).  A single partition keeps its scalars (pid, n_core) as ints; a
    stacked bundle holds [n, ...] tensors, scalars as [n] int32.  A bundle
    placed over a part mesh holds one stacked entry per shard in
    ``shards`` (keyed by the shard's pids) and no tensors of its own."""

    key: StoreKey
    part: Dict[str, Union[int, torch.Tensor]]
    g2l: Optional[torch.Tensor]  # [V] row, or [n, V] for a stacked bundle
    nbytes: int                  # bytes of the host numpy bundle(s)
    prefetched: bool = False     # staged by prefetch(), not yet touched by get()
    ready: Optional[Any] = None  # CUDA event the side-stream copy recorded
    shards: Tuple["StoreEntry", ...] = ()

    @property
    def cost_parts(self) -> int:
        return len(self.key) if isinstance(self.key, tuple) else 1


class PartitionStore:
    """Owns which partitions are device-resident for one PartitionedGraph.

    ``device=None`` means ``"cuda"`` (and raises with no card); the tests
    pass ``device="cpu"``.
    """

    def __init__(self, pg: PartitionedGraph,
                 capacity_parts: Optional[int] = None,
                 capacity_bytes: Optional[int] = None,
                 max_stacked_entries: Optional[int] = 8,
                 backing: Optional[Any] = None,
                 host_cache_parts: Optional[int] = None,
                 host_cache_bytes: Optional[int] = None,
                 read_ahead: bool = True,
                 tracer: Optional[Any] = None,
                 device: Union[None, str, torch.device] = None,
                 profiler: Optional[Any] = None):
        if capacity_parts is not None and capacity_parts < 1:
            raise ValueError(f"capacity_parts must be >= 1, got {capacity_parts}")
        if capacity_bytes is not None and capacity_bytes < 1:
            raise ValueError(f"capacity_bytes must be >= 1, got {capacity_bytes}")
        if max_stacked_entries is not None and max_stacked_entries < 1:
            raise ValueError(f"max_stacked_entries must be >= 1, "
                             f"got {max_stacked_entries}")
        self.device = resolve_device(device)
        self.pg = pg
        self.capacity_parts = capacity_parts
        self.capacity_bytes = capacity_bytes
        self.max_stacked_entries = max_stacked_entries
        self.stats = LoadStats()
        self.backing = backing
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # device live bytes sampled as load spans close (obs/profile.py)
        self.profiler = profiler if profiler is not None else NULL_PROFILER
        cuda = self.device.type == "cuda"
        # the host tier the device cache stages from: the whole graph in
        # RAM, or a disk-backed host LRU with background read-ahead
        if backing is not None:
            self._host_tier: Any = HostShardCache(
                backing, self.stats, capacity_parts=host_cache_parts,
                capacity_bytes=host_cache_bytes, read_ahead=read_ahead,
                pin=cuda, tracer=self.tracer)
        else:
            self._host_tier = HostArrayTier(pg, pin=cuda)
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        # cache key (a plain key, or its bundle tokens under a view) ->
        # entry; the entry's own ``key`` is always the plain key
        self._cache: "OrderedDict[Any, StoreEntry]" = OrderedDict()
        # the owner table per device, with no view
        self._owner_dev: Dict[torch.device, torch.Tensor] = {}
        # pinned plain keys (refcounted): protected from LRU eviction while
        # a caller evaluates against them — the double-buffer guarantee
        self._pins: Dict[StoreKey, int] = {}
        # the ambient generation view, per thread (``viewing``)
        self._local = threading.local()
        # the owner table per (generation, seq), per device: a small LRU
        self._owner_cache: "OrderedDict[Tuple[int, int], Dict[torch.device, torch.Tensor]]" \
            = OrderedDict()

    # -- generation views (mutable graph directories) -----------------------

    @property
    def view(self):
        """The calling thread's ambient GenerationView, or None."""
        return getattr(self._local, "view", None)

    @contextlib.contextmanager
    def viewing(self, view):
        """``with store.viewing(view): ...`` — every load in the block
        resolves against that pinned generation (module docstring);
        ``view=None`` restores the plain-pid behaviour for the block."""
        prev = getattr(self._local, "view", None)
        self._local.view = view
        try:
            yield self
        finally:
            self._local.view = prev

    @property
    def current_generation(self) -> Optional[int]:
        """The generation the thread's loads resolve against (None: a
        store with no backing)."""
        v = self.view
        if v is not None:
            return int(v.generation)
        return int(self.backing.generation) if self.backing is not None else None

    def _vk(self, pid: int):
        """The cache key one pid resolves to: the ambient view's bundle
        token, or the plain pid."""
        v = self.view
        return int(pid) if v is None else v.bundle_token(int(pid))

    def _vkey(self, key: StoreKey):
        if isinstance(key, tuple):
            return tuple(self._vk(p) for p in key)
        return self._vk(key)

    def _host_get(self, pid: int):
        """Host-tier lookup of one pid under the ambient view."""
        if self.view is None:
            return self._host_tier.get(int(pid))
        return self._host_tier.get(self._vk(pid), loader=self._overlay_loader(pid))

    def _overlay_loader(self, pid: int):
        """A host-miss loader bound to the ambient view: the pinned
        generation's arrays for ``pid`` at the view's geometry (the host
        tier pins them, on its worker for a read-ahead)."""
        v, pid = self.view, int(pid)
        return lambda: v.load_bundle(pid)

    def _count_overlays(self, key: StoreKey) -> None:
        """Count, on the calling thread and before the load, every stale
        pid of ``key`` the ambient view will rebuild from its overlay."""
        v = self.view
        if v is None:
            return
        stale = v.stale_pids
        for p in (key if isinstance(key, tuple) else (key,)):
            if int(p) in stale and not self._host_tier.resident(self._vk(p)):
                self.stats.delta_overlays += 1

    # -- global (non-partition) arrays ------------------------------------

    @property
    def owner(self) -> torch.Tensor:
        """[V] owner table on the store's device (``owner_on``)."""
        return self.owner_on(self.device)

    def owner_on(self, device: Union[str, torch.device]) -> torch.Tensor:
        """[V] owner table on ``device``.  With no view, ``pg.owner``
        copied once per device; under a view, the view's assignment (vertex
        adds grow V), copied once per (generation, seq) and device."""
        dev = normalize_device(device)
        v = self.view
        if v is None:
            per = self._owner_dev
            src = self.pg.owner
        else:
            ok = (int(v.generation), int(v.seq))
            per = self._owner_cache.get(ok)
            if per is None:
                per = self._owner_cache[ok] = {}
                while len(self._owner_cache) > 4:
                    self._owner_cache.popitem(last=False)
            self._owner_cache.move_to_end(ok)
            src = v.assignment
        got = per.get(dev)
        if got is None:
            got = per[dev] = torch.from_numpy(np.asarray(src, dtype=np.int32)).to(dev)
        return got

    @property
    def part_keys(self):
        """Key set of the evaluator input dict (shared by every entry)."""
        return self._host_tier.part_keys

    @property
    def host_tier(self):
        """The disk→host staging tier (storage/host_cache.py)."""
        return self._host_tier

    def resident_keys(self) -> list:
        return [e.key for e in self._cache.values()]

    def contains(self, key: StoreKey) -> bool:
        """True when ``key`` is device-resident under any view."""
        return bool(self._cache_keys_for(key))

    def host_nbytes(self, pid: int) -> int:
        return self._host_tier.nbytes(int(pid))

    # -- loads -------------------------------------------------------------

    def get(self, pid: int) -> StoreEntry:
        """One partition's evaluator inputs, device-resident (OPAT's load),
        safe to read on the current stream."""
        return self._lookup(int(pid))

    def get_stacked(self, pids: Sequence[int],
                    device: Union[None, str, torch.device, PartMesh] = None
                    ) -> StoreEntry:
        """A stacked [n, ...] bundle over ``pids`` (order-sensitive), the
        unit TraditionalMP ships per iteration and MapReduceMP ships once.
        ``device`` places it: None is the store's device; a ``PartMesh``
        of n mappers splits it into one stacked entry per shard, on the
        shard's device (``StoreEntry.shards``)."""
        key = tuple(int(p) for p in pids)
        if not key:
            raise ValueError("get_stacked needs at least one partition id")
        if isinstance(device, PartMesh) and device.k != len(key):
            raise ValueError(f"a mesh of {device.k} mappers cannot place "
                             f"{len(key)} partitions")
        return self._lookup(key, device)

    def prefetch(self, pid: int) -> bool:
        """Stage ``pid`` off the critical path: a side-stream copy on CUDA
        when it is host-resident; with a disk backing, a partition not yet
        in host RAM gets a background-thread *read-ahead* instead (a
        device copy now would block this thread on the disk read).
        Returns True when work was issued (False: already resident or in
        flight)."""
        pid = int(pid)
        vk = self._vk(pid)
        if vk in self._cache:
            return False
        if not self._host_tier.resident(vk):
            v = self.view
            if v is None:
                return self._host_tier.read_ahead(pid)
            issued = self._host_tier.read_ahead(vk, loader=self._overlay_loader(pid))
            if issued and pid in v.stale_pids:
                self.stats.delta_overlays += 1
            return issued
        with self.tracer.span("store.prefetch", pid=pid) as sp:
            entry = self._stage(pid, side_stream=True)
            entry.prefetched = True
            self.stats.prefetch_issued += 1
            self.stats.bytes_prefetched += entry.nbytes
            sp.set(nbytes=entry.nbytes)
            self._insert(entry, vk)
            self.profiler.sample_device(sp, self)
        return True

    # -- pinning (double-buffered streaming) --------------------------------

    def pin(self, key: StoreKey) -> None:
        """Protect ``key`` from LRU eviction until the matching unpin().
        While partition i is evaluated, prefetching the runner-up may push
        the cache over capacity; pinning i guarantees the staging evicts
        something else.  The cache may transiently exceed its budget by
        the pinned entries.  Pins refcount; ``drop`` / ``release`` still
        remove a pinned entry (pins only guard the implicit LRU path)."""
        k = self._normkey(key)
        self._pins[k] = self._pins.get(k, 0) + 1

    def unpin(self, key: StoreKey) -> None:
        k = self._normkey(key)
        n = self._pins.get(k, 0) - 1
        if n <= 0:
            self._pins.pop(k, None)
            # restore the capacity invariant now that the entry is
            # evictable again
            self._evict_to_capacity(keep=None)
        else:
            self._pins[k] = n

    @contextlib.contextmanager
    def pinned(self, *keys: StoreKey):
        """``with store.pinned(pid): ...`` — pin for the block's duration."""
        for k in keys:
            self.pin(k)
        try:
            yield self
        finally:
            for k in keys:
                self.unpin(k)

    def drop(self, key: StoreKey) -> bool:
        """Remove every view's device entry of ``key`` (not counted as an
        eviction)."""
        cks = self._cache_keys_for(key)
        for ck in cks:
            del self._cache[ck]
        return bool(cks)

    def release(self, key: StoreKey) -> bool:
        """A counted ``drop``: the scheduler's retirement hook, observable
        as ``LoadStats.released``.  A later ``get`` re-stages cold."""
        ok = self.drop(key)
        if ok:
            self.stats.released += 1
        return ok

    def clear(self) -> None:
        """Drop every device entry (the host tier is untouched: cleared
        device residency is a serving experiment, not an invalidation)."""
        self._cache.clear()

    def close(self) -> None:
        """Release both cache tiers and join any in-flight read-ahead —
        the teardown hook ``GraphSession`` calls before rebinding, so a
        repartitioned session can never be served stale host entries of
        the old layout."""
        self._cache.clear()
        self._host_tier.clear()

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _normkey(key: StoreKey) -> StoreKey:
        return tuple(int(p) for p in key) if isinstance(key, tuple) else int(key)

    def _cache_keys_for(self, key: StoreKey) -> list:
        """Every cache key whose entry stages ``key`` (one per view)."""
        nk = self._normkey(key)
        return [ck for ck, e in self._cache.items() if e.key == nk]

    def _lookup(self, key: StoreKey, placement: Any = None) -> StoreEntry:
        ck = self._vkey(key)
        if isinstance(placement, PartMesh):
            ck = (ck, placement.key)
        elif placement is not None:
            placement = normalize_device(placement)
            ck = (ck, str(placement))
        with self.tracer.span("store.load", pid=key) as sp:
            got = self._cache.get(ck)
            if got is not None:
                self._cache.move_to_end(ck)
                self.stats.hits += 1
                if got.prefetched:
                    got.prefetched = False
                    self.stats.prefetch_hits += 1
                    sp.set(tier="prefetch")
                else:
                    sp.set(tier="warm")
                self._await(got)
                self.profiler.sample_device(sp, self)
                return got
            sp.set(tier="cold")
            entry = (self._stage_stacked(key, placement) if isinstance(key, tuple)
                     else self._stage(key, side_stream=False))
            self.stats.misses += 1
            self.stats.bytes_cold += entry.nbytes
            sp.set(nbytes=entry.nbytes, generation=self.current_generation)
            self._insert(entry, ck)
            self.profiler.sample_device(sp, self)
            return entry

    def _stage(self, pid: int, side_stream: bool) -> StoreEntry:
        """Pull the host bundle through the host tier (an in-RAM bundle, a
        host-LRU hit, a disk shard read, or under a view the view's
        loader) and copy it to the device."""
        self._count_overlays(pid)
        part_h, g2l_h, nbytes = self._host_get(pid)
        if self.device.type != "cuda":
            return StoreEntry(key=pid, part=dict(part_h), g2l=g2l_h, nbytes=nbytes)

        def copy():
            part = {k: (v if isinstance(v, int) else v.to(self.device, non_blocking=True))
                    for k, v in part_h.items()}
            return part, g2l_h.to(self.device, non_blocking=True)

        if not side_stream:
            part, g2l = copy()
            return StoreEntry(key=pid, part=part, g2l=g2l, nbytes=nbytes)
        with torch.cuda.stream(self._copy_stream):
            part, g2l = copy()
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return StoreEntry(key=pid, part=part, g2l=g2l, nbytes=nbytes, ready=ready)

    def _stage_stacked(self, key: Tuple[int, ...], placement: Any) -> StoreEntry:
        """Stack the partitions of ``key`` on ``placement`` (None: the
        store's device; a device; or one stack per shard of a mesh).  The
        bundles are held here until every slice's copy is issued: a host
        tier smaller than ``key`` evicts one while the next is read."""
        self._count_overlays(key)
        bundles = [self._host_get(p) for p in key]
        if not isinstance(placement, PartMesh):
            return self._stack(key, bundles,
                               self.device if placement is None else placement)
        shards, lo = [], 0
        for sh in placement.shards:
            hi = lo + len(sh.pids)
            shards.append(self._stack(key[lo:hi], bundles[lo:hi], sh.device))
            lo = hi
        return StoreEntry(key=key, part={}, g2l=None,
                          nbytes=sum(e.nbytes for e in shards), shards=tuple(shards))

    @staticmethod
    def _stack(key: Tuple[int, ...], bundles: list, device: torch.device) -> StoreEntry:
        """One stacked entry of ``bundles`` on ``device``, on its current
        stream.  On CUDA each partition's page-locked host tensors copy
        (``non_blocking``) straight into their slice of the stacked device
        tensor, so no unpinned stacked host copy is ever made."""
        nbytes = sum(b.nbytes for b in bundles)
        scalars = {k: torch.tensor([b.part[k] for b in bundles], dtype=torch.int32)
                   for k, v in bundles[0].part.items() if isinstance(v, int)}
        tensors = [(k, [b.part[k] for b in bundles])
                   for k, v in bundles[0].part.items() if not isinstance(v, int)]
        tensors.append(("g2l", [b.g2l for b in bundles]))
        if device.type != "cuda":
            stacked = {k: torch.stack(ts) for k, ts in tensors}
        else:
            stacked = {}
            for k, ts in tensors:
                out = torch.empty((len(ts), *ts[0].shape), dtype=ts[0].dtype,
                                  device=device)
                for i, t in enumerate(ts):
                    out[i].copy_(t, non_blocking=True)
                stacked[k] = out
            scalars = {k: v.pin_memory().to(device, non_blocking=True)
                       for k, v in scalars.items()}
        g2l = stacked.pop("g2l")
        return StoreEntry(key=key, part={**scalars, **stacked}, g2l=g2l,
                          nbytes=nbytes)

    def _await(self, entry: StoreEntry) -> None:
        """Order the current stream after a side-stream copy, once."""
        if entry.ready is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(entry.ready)
        for t in (*entry.part.values(), entry.g2l):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        entry.ready = None

    def _insert(self, entry: StoreEntry, cache_key) -> None:
        self._cache[cache_key] = entry
        self._cache.move_to_end(cache_key)
        self._evict_to_capacity(keep=cache_key)

    def _evict_to_capacity(self, keep: Optional[StoreKey]) -> None:
        """Drop least-recently-used entries until within capacity.  The
        just-inserted entry and pinned entries are never evicted, so the
        cache can transiently exceed capacity by the pinned set.  A stacked
        bundle costs its length in partitions, and at most
        ``max_stacked_entries`` bundles stay."""
        def over() -> bool:
            if self.capacity_parts is not None \
                    and sum(e.cost_parts for e in self._cache.values()) > self.capacity_parts:
                return True
            if self.capacity_bytes is not None \
                    and sum(e.nbytes for e in self._cache.values()) > self.capacity_bytes:
                return True
            return False

        def evict(candidates) -> bool:
            victim = next((k for k in candidates
                           if k != keep and self._cache[k].key not in self._pins), None)
            if victim is None:
                return False
            gone = self._cache.pop(victim)
            self.stats.evictions += 1
            if self.tracer.enabled:
                # unread: a prefetch no get ever used, its copy wasted
                self.tracer.event("store.evict", pid=gone.key, nbytes=gone.nbytes,
                                  unread=gone.prefetched)
            return True

        while over() and evict(list(self._cache)):
            pass
        if self.max_stacked_entries is not None:
            def stacked():
                return [k for k, e in self._cache.items() if isinstance(e.key, tuple)]
            while len(stacked()) > self.max_stacked_entries and evict(stacked()):
                pass
