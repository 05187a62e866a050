"""Streaming mutations over a graph directory: per-partition delta logs,
generation-pinned snapshot views, and log→shard compaction.

A copy of the JAX package's ``storage/deltas.py``, logic unchanged; it
writes only through storage/format.py's atomic helpers, so the port's
``format.fault_hook`` sees every durable write.

The storage layer (storage/format.py) made the graph directory a
content-addressed, atomically published *generation*; this module makes
it mutable without ever serving an inconsistent snapshot — the
snapshot-vs-freshness trade-off of "Systems for Near Real-Time Analysis
of Large-Scale Dynamic Graphs" (PAPERS.md):

  delta logs     — writers append edge/vertex insert+delete records to
      per-partition JSON-lines logs (``deltas-<pid>.log``).  Every record
      carries a monotone global ``seq`` and a checksum; every append is a
      whole-file atomic rewrite (temp + rename, same discipline as
      shards), and records are appended ONE AT A TIME in seq order, so a
      crash always leaves a durable *prefix* of the mutation history —
      never a record whose dependency (an earlier seq) was lost.
  snapshot views — ``MutableGraphDirectory.snapshot()`` returns a
      ``GenerationView``: the manifest at snapshot time plus the pending
      records, pinned against GC.  Readers overlay pending deltas onto a
      shard at staging time (``GenerationView.load_bundle`` — the loader
      ``PartitionStore._stage`` routes through the host tier with a
      generation-aware cache token), so queries running on a view answer
      from one consistent generation while writers keep appending.
  compaction     — ``compact(pid)`` folds the pending history into a new
      content-addressed shard for ``pid`` plus a new content-addressed
      whole-graph file, then publishes both with ONE atomic manifest
      rename (generation+1).  A crash at any intermediate step leaves the
      previous generation fully servable (fault_hook in format.py turns
      this claim into tests/test_torch_mutation.py's crash sweep).
      Superseded files are garbage-collected only once no pinned view
      references them.

Deletion semantics: ``vertex_del`` removes every incident edge and
re-labels the vertex with the reserved label ``__deleted__`` (value NaN),
keeping its gid slot so answers stay stable and a from-scratch rebuild of
the same final state is gid-identical.  A tombstone still matches a
wildcard-label query node (it matches "any label" by definition) but no
concrete label — and with no edges it can never extend a path.

Watermarks: the manifest's ``applied_seq`` says the whole-graph file
reflects records up to that seq; per-partition ``shard_seq[pid]`` says
the same for each shard.  A partition is *stale* in a view iff some
pending record touching it has ``seq > shard_seq[pid]``; stale bundles
are rebuilt from the overlay graph (same ``build_partitions`` code path
as a from-scratch save, so the delta path cannot diverge from a rebuild
— the property the JAX package's tests/test_property.py checks).  A
record leaves the log once folded into the graph file AND every touched shard.

Pins are in-process (one writer process per directory); multi-process
coordination is the multi-host open item in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import (Graph, LabelVocab, PartitionedGraph,
                          build_partitions)
from .format import (DiskCatalog, OutOfCorePartitionedGraph,
                     StorageFormatError, _atomic_savez, _atomic_write_text,
                     _content_key, _fault_point, _label_histogram,
                     array_checksum, gc_directory, graph_file_name,
                     pad_bundle, save_partitioned_graph, shard_name,
                     write_manifest)

DELTA_LOG_KIND = "pgqp-delta-log"
DELTA_LOG_VERSION = 1
DELETED_LABEL = "__deleted__"

EDGE_ADD = "edge_add"
EDGE_DEL = "edge_del"
VERTEX_ADD = "vertex_add"
VERTEX_DEL = "vertex_del"
DELTA_OPS = (EDGE_ADD, EDGE_DEL, VERTEX_ADD, VERTEX_DEL)


def log_name(pid: int) -> str:
    return f"deltas-{int(pid):05d}.log"


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaRecord:
    """One mutation.  ``u``/``v`` are endpoint gids for edge ops; ``u`` is
    the vertex gid for vertex ops.  Labels travel as STRINGS (interned at
    apply time, so records survive vocab growth across generations).
    ``touched`` is the pid set whose shards the record invalidates."""

    seq: int
    op: str
    u: int = -1
    v: int = -1
    label: str = ""
    directed: bool = False
    value: float = math.nan
    pid: int = -1                      # vertex_add: assigned partition
    touched: Tuple[int, ...] = ()

    def payload(self) -> Dict[str, Any]:
        return {"seq": int(self.seq), "op": self.op, "u": int(self.u),
                "v": int(self.v), "label": self.label,
                "directed": bool(self.directed),
                "value": None if math.isnan(self.value) else float(self.value),
                "pid": int(self.pid),
                "touched": [int(p) for p in self.touched]}

    def checksum(self) -> str:
        blob = json.dumps(self.payload(), sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def to_json(self) -> str:
        d = self.payload()
        d["checksum"] = self.checksum()
        return json.dumps(d, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeltaRecord":
        if d.get("op") not in DELTA_OPS:
            raise StorageFormatError(f"unknown delta op {d.get('op')!r}")
        rec = cls(seq=int(d["seq"]), op=d["op"], u=int(d.get("u", -1)),
                  v=int(d.get("v", -1)), label=d.get("label", ""),
                  directed=bool(d.get("directed", False)),
                  value=(math.nan if d.get("value") is None
                         else float(d["value"])),
                  pid=int(d.get("pid", -1)),
                  touched=tuple(int(p) for p in d.get("touched", ())))
        want = d.get("checksum")
        if want is not None and want != rec.checksum():
            raise StorageFormatError(
                f"delta record seq={rec.seq} checksum mismatch "
                f"(log is corrupt or torn)")
        return rec


# ---------------------------------------------------------------------------
# The log
# ---------------------------------------------------------------------------

class DeltaLog:
    """Per-partition JSON-lines logs under one graph directory.

    A record's *primary* log is ``deltas-<min(touched)>.log`` (one durable
    write per record, in seq order → crash-prefix durability).  Reading
    merges every log, verifies per-record checksums, and checks the merged
    seq sequence is strictly increasing — a gap or duplicate means a torn
    or foreign log and raises rather than serving wrong answers.
    """

    def __init__(self, path: str):
        self.path = path
        # per-file line cache so appends don't re-read O(n) from disk
        self._lines: Dict[str, List[str]] = {}

    def _log_files(self) -> List[str]:
        return sorted(f for f in os.listdir(self.path)
                      if f.startswith("deltas-") and f.endswith(".log"))

    def _read_file(self, fname: str) -> List[str]:
        if fname not in self._lines:
            fpath = os.path.join(self.path, fname)
            if not os.path.exists(fpath):
                self._lines[fname] = []
            else:
                with open(fpath) as f:
                    lines = [ln.rstrip("\n") for ln in f if ln.strip()]
                if lines:
                    head = json.loads(lines[0])
                    if head.get("kind") != DELTA_LOG_KIND:
                        raise StorageFormatError(
                            f"{fname} is not a delta log")
                self._lines[fname] = lines[1:] if lines else []
        return self._lines[fname]

    def load(self) -> List[DeltaRecord]:
        """Every record across every log, checksum-verified, seq-sorted,
        monotonicity-checked."""
        recs: List[DeltaRecord] = []
        for fname in self._log_files():
            for ln in self._read_file(fname):
                recs.append(DeltaRecord.from_dict(json.loads(ln)))
        recs.sort(key=lambda r: r.seq)
        for a, b in zip(recs, recs[1:]):
            if b.seq <= a.seq:
                raise StorageFormatError(
                    f"delta logs have duplicate seq {b.seq}")
        return recs

    def append(self, rec: DeltaRecord) -> None:
        """Durably append one record (whole-file atomic rewrite of its
        primary log).  Callers append in seq order, one at a time."""
        if not rec.touched:
            raise ValueError("delta record must touch at least one pid")
        fname = log_name(min(rec.touched))
        lines = list(self._read_file(fname))
        lines.append(rec.to_json())
        header = json.dumps({"kind": DELTA_LOG_KIND,
                             "version": DELTA_LOG_VERSION})
        _atomic_write_text(os.path.join(self.path, fname),
                           "\n".join([header] + lines) + "\n")
        self._lines[fname] = lines

    def trim(self, applied_seq: int, shard_seq: Sequence[int]) -> int:
        """Drop records folded into the graph file AND every touched
        shard; rewrite (or delete) each log atomically.  Returns the
        number of records dropped — crash-safe: a partial trim leaves
        some folded records behind, and the next open trims them again.
        """

        def folded(r: DeltaRecord) -> bool:
            return (r.seq <= int(applied_seq)
                    and all(r.seq <= int(shard_seq[p]) for p in r.touched))

        dropped = 0
        for fname in self._log_files():
            lines = self._read_file(fname)
            keep = []
            for ln in lines:
                if folded(DeltaRecord.from_dict(json.loads(ln))):
                    dropped += 1
                else:
                    keep.append(ln)
            if len(keep) == len(lines):
                continue
            fpath = os.path.join(self.path, fname)
            if keep:
                header = json.dumps({"kind": DELTA_LOG_KIND,
                                     "version": DELTA_LOG_VERSION})
                _atomic_write_text(fpath, "\n".join([header] + keep) + "\n")
                self._lines[fname] = keep
            else:
                _fault_point("unlink", fpath)
                os.remove(fpath)
                self._lines[fname] = []
        return dropped


# ---------------------------------------------------------------------------
# Overlay application
# ---------------------------------------------------------------------------

def _copy_vocab(v: LabelVocab) -> LabelVocab:
    out = LabelVocab()
    for i in range(len(v)):
        out.intern(v.str_of(i))
    return out


def apply_records(graph: Graph, assignment: np.ndarray,
                  records: Sequence[DeltaRecord]
                  ) -> Tuple[Graph, np.ndarray]:
    """Overlay ``records`` (seq order) onto ``graph``; returns a NEW
    (graph, assignment) — inputs are never mutated, so snapshot views can
    share the arrays they were built from."""
    if not records:
        return graph, assignment
    node_label = np.array(graph.node_label)
    node_value = np.array(graph.node_value)
    esrc = np.array(graph.edge_src)
    edst = np.array(graph.edge_dst)
    elab = np.array(graph.edge_label)
    edir = np.array(graph.edge_directed)
    assign = np.array(assignment, dtype=np.int32)
    node_vocab = _copy_vocab(graph.node_vocab)
    edge_vocab = _copy_vocab(graph.edge_vocab)

    for r in sorted(records, key=lambda r: r.seq):
        if r.op == VERTEX_ADD:
            if r.u != len(node_label):
                raise StorageFormatError(
                    f"vertex_add seq={r.seq} gid {r.u} != next gid "
                    f"{len(node_label)} (log replayed out of order?)")
            node_label = np.append(node_label,
                                   np.int32(node_vocab.intern(r.label)))
            node_value = np.append(
                node_value, np.asarray(r.value, dtype=node_value.dtype))
            assign = np.append(assign, np.int32(r.pid))
        elif r.op == VERTEX_DEL:
            node_label[r.u] = node_vocab.intern(DELETED_LABEL)
            node_value[r.u] = np.nan
            keep = (esrc != r.u) & (edst != r.u)
            esrc, edst = esrc[keep], edst[keep]
            elab, edir = elab[keep], edir[keep]
        elif r.op == EDGE_ADD:
            esrc = np.append(esrc, np.int32(r.u))
            edst = np.append(edst, np.int32(r.v))
            elab = np.append(elab, np.int32(edge_vocab.intern(r.label)))
            edir = np.append(edir, edir.dtype.type(r.directed))
        elif r.op == EDGE_DEL:
            lid = edge_vocab.get(r.label, -10)
            keep = ~((esrc == r.u) & (edst == r.v) & (elab == lid))
            esrc, edst = esrc[keep], edst[keep]
            elab, edir = elab[keep], edir[keep]
    g = Graph(n_nodes=int(len(node_label)),
              node_label=node_label, node_value=node_value,
              edge_src=esrc, edge_dst=edst, edge_label=elab,
              edge_directed=edir,
              node_vocab=node_vocab, edge_vocab=edge_vocab)
    g.validate()
    return g, assign


# ---------------------------------------------------------------------------
# Generation views
# ---------------------------------------------------------------------------

class GenerationView:
    """One pinned, immutable snapshot: the manifest at snapshot time plus
    the pending delta records.  Everything a query needs — the overlay
    graph, per-partition staging bundles at one uniform geometry, SNI
    counts — comes from this object, so answers are always consistent
    with exactly one generation + seq watermark."""

    def __init__(self, mdir: "MutableGraphDirectory", catalog: DiskCatalog,
                 records: Tuple[DeltaRecord, ...], graph: Graph,
                 assignment: np.ndarray, seq: int):
        self.mdir = mdir
        self.catalog = catalog
        self.records = records
        self.graph = graph
        self.assignment = np.asarray(assignment, dtype=np.int32)
        self.seq = int(seq)
        self.generation = catalog.generation
        self._stale = {p for r in records for p in r.touched
                       if r.seq > catalog.shard_seq(p)}
        self._geom: Optional[Tuple[int, int, int]] = None
        self._rebuilt: Optional[PartitionedGraph] = None
        self._lock = threading.Lock()

    # -- geometry ----------------------------------------------------------

    def _ensure_geometry(self) -> None:
        with self._lock:
            if self._geom is not None:
                return
            m = self.catalog.manifest
            if not self._stale:
                self._geom = (int(m["node_pad"]), int(m["edge_pad"]),
                              int(m["ell_width"]))
                return
            # rebuild the overlay layout through the SAME code path a
            # from-scratch save uses — the delta path cannot diverge
            self._rebuilt = build_partitions(
                self.graph, self.assignment.astype(np.int64),
                self.catalog.k, scheme=self.catalog.scheme)
            self._geom = (max(int(m["node_pad"]), self._rebuilt.node_pad),
                          max(int(m["edge_pad"]), self._rebuilt.edge_pad),
                          max(int(m["ell_width"]), self._rebuilt.ell_width))

    @property
    def node_pad(self) -> int:
        self._ensure_geometry()
        return self._geom[0]

    @property
    def edge_pad(self) -> int:
        self._ensure_geometry()
        return self._geom[1]

    @property
    def ell_width(self) -> int:
        self._ensure_geometry()
        return self._geom[2]

    @property
    def stale_pids(self) -> set:
        return set(self._stale)

    def seq_for(self, pid: int) -> int:
        """The seq watermark of partition ``pid``'s bundle in this view."""
        pid = int(pid)
        pending = [r.seq for r in self.records
                   if pid in r.touched and r.seq > self.catalog.shard_seq(pid)]
        return max(pending) if pending else self.catalog.shard_seq(pid)

    def bundle_token(self, pid: int) -> Tuple:
        """The host-cache key of ``pid``'s staging bundle: pid + what it
        was built from (generation, delta watermark, target geometry) —
        two views with identical tokens produce byte-identical bundles,
        so the host tier can share them across generations."""
        self._ensure_geometry()
        return (int(pid), self.generation, self.seq_for(pid),
                self._geom[0], self._geom[2], int(self.graph.n_nodes))

    # -- staging -----------------------------------------------------------

    def load_bundle(self, pid: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """One partition's evaluator bundle under this view: the shard as
        stored when clean, the overlay rebuild when stale — both padded
        to the view's uniform geometry.  Returns (part dict, g2l row)."""
        pid = int(pid)
        self._ensure_geometry()
        if pid in self._stale:
            from .format import _shard_arrays
            with self.mdir.tracer.span("deltas.overlay_rebuild", pid=pid,
                                       generation=int(self.generation),
                                       seq=int(self.seq_for(pid))) as sp:
                arrs = _shard_arrays(self._rebuilt, pid)
                sp.set(nbytes=sum(int(a.nbytes) for a in arrs.values()))
        else:
            part, g2l = self.catalog.read_part(pid)
            arrs = dict(part)
            arrs["g2l"] = g2l
        arrs = pad_bundle(arrs, self._geom[0], self._geom[2],
                          int(self.graph.n_nodes))
        g2l = arrs.pop("g2l")
        return arrs, g2l

    # -- catalog-level metrics (SNI / CC) ---------------------------------

    def start_label_counts(self, label_id: int, value_op: int = 0,
                           value: float = 0.0) -> np.ndarray:
        """SNI per partition under THIS view.  A clean view answers from
        the manifest histograms (no shard touched, as an opened directory); a
        view with pending deltas counts over the overlay arrays — the
        counts seed scheduler admission, so they must match what the
        evaluator will actually find or answers would be missed."""
        if not self.records:
            return self.catalog.start_label_counts(label_id, value_op, value)
        from ..core.graph import start_label_counts_from_arrays
        return start_label_counts_from_arrays(
            np.asarray(self.graph.node_label),
            np.asarray(self.graph.node_value),
            self.assignment, self.catalog.k, label_id, value_op, value)

    def connected_components_per_partition(self) -> np.ndarray:
        # ranking-only metric (MAX-YIELD tie-break, cost model): the
        # catalog's folded values are close enough between compactions
        return self.catalog.components_per_partition()

    def cut_edges(self) -> int:
        if not self.records:
            return int(self.catalog.manifest["cut_edges"])
        return int(np.sum(self.assignment[np.asarray(self.graph.edge_src)]
                          != self.assignment[np.asarray(self.graph.edge_dst)]))

    def files(self) -> set:
        """Content-addressed files this view needs alive (GC keep-set)."""
        m = self.catalog.manifest
        return ({p["shard"] for p in m["partitions"]}
                | {self.catalog.graph_file})

    def as_partitioned_graph(self) -> "SnapshotPartitionedGraph":
        return SnapshotPartitionedGraph(self)

    # -- pinning -----------------------------------------------------------

    def pin(self) -> "GenerationView":
        self.mdir.pin(self)
        return self

    def release(self) -> None:
        self.mdir.unpin(self)


class SnapshotPartitionedGraph(OutOfCorePartitionedGraph):
    """The ``PartitionedGraph`` a session binds for one generation view:
    overlay graph + assignment, the view's uniform geometry, SNI answered
    from the view — engines and the scheduler stay oblivious."""

    def __init__(self, view: GenerationView):
        assignment = view.assignment
        PartitionedGraph.__init__(
            self, graph=view.graph, k=view.catalog.k,
            assignment=assignment, parts=[], owner=assignment.copy(),
            g2l=None, cut_edges=view.cut_edges(),
            node_pad=view.node_pad, edge_pad=view.edge_pad,
            scheme=view.catalog.scheme)
        self.backing = view.catalog
        self.view = view
        self._ell_width = view.ell_width

    def start_label_counts(self, label_id: int, value_op: int = 0,
                           value: float = 0.0) -> np.ndarray:
        return self.view.start_label_counts(label_id, value_op, value)

    def connected_components_per_partition(self) -> np.ndarray:
        return self.view.connected_components_per_partition()


# ---------------------------------------------------------------------------
# The mutable directory
# ---------------------------------------------------------------------------

class MutableGraphDirectory:
    """One writable graph directory: append deltas, snapshot generations,
    compact, GC — the single-process writer side of the storage layer.

    Opening replays (and re-trims) the logs, so a crash anywhere —
    mid-append, mid-compaction, mid-GC — recovers to the last published
    generation plus every durably appended record.
    """

    def __init__(self, path: str, verify_checksums: bool = True):
        self.path = path
        self.verify_checksums = verify_checksums
        self.catalog = DiskCatalog(path, verify_checksums)
        self.log = DeltaLog(path)
        records = self.log.load()
        # a crash after a publish but before the log trim leaves folded
        # records behind; trim them now (idempotent)
        self.log.trim(self.catalog.applied_seq,
                      [self.catalog.shard_seq(p)
                       for p in range(self.catalog.k)])
        self._records: List[DeltaRecord] = [
            r for r in records
            if not (r.seq <= self.catalog.applied_seq
                    and all(r.seq <= self.catalog.shard_seq(p)
                            for p in r.touched))]
        # the running overlay (what snapshot() hands out); graph-file
        # records (seq <= applied_seq) are already IN the catalog graph
        base = self.catalog.load_graph()
        base_assign = np.asarray(self.catalog.assignment, dtype=np.int32)
        pending_graph = [r for r in self._records
                         if r.seq > self.catalog.applied_seq]
        self._graph, self._assign = apply_records(base, base_assign,
                                                  pending_graph)
        self._pins: Dict[int, List] = {}   # id(view) -> [view, refcount]
        self._lock = threading.RLock()
        self.compactions = 0
        # observability: GraphSession.open swaps in its live tracer; the
        # default no-op keeps standalone directory use untraced
        from ..obs.trace import NULL_TRACER
        self.tracer = NULL_TRACER

    # -- introspection ------------------------------------------------------

    @property
    def k(self) -> int:
        return self.catalog.k

    @property
    def generation(self) -> int:
        return self.catalog.generation

    def max_seq(self) -> int:
        with self._lock:
            seqs = [self.catalog.applied_seq]
            seqs += [self.catalog.shard_seq(p) for p in range(self.k)]
            seqs += [r.seq for r in self._records]
            return max(seqs)

    def pending_counts(self) -> np.ndarray:
        """Per-partition pending-delta volume — the ``workload_profile``
        signal that drives continuous repartitioning of hot-update
        partitions (WawPart, PAPERS.md)."""
        counts = np.zeros(self.k, dtype=np.int64)
        with self._lock:
            for r in self._records:
                for p in r.touched:
                    if r.seq > self.catalog.shard_seq(p):
                        counts[p] += 1
        return counts

    # -- writes -------------------------------------------------------------

    def _append(self, rec: DeltaRecord) -> DeltaRecord:
        # durable first (crash after this point keeps the record), then
        # the in-memory overlay
        with self.tracer.span("deltas.append", op=str(rec.op),
                              seq=int(rec.seq), touched=list(rec.touched)):
            self.log.append(rec)
            self._records.append(rec)
            self._graph, self._assign = apply_records(
                self._graph, self._assign, [rec])
        return rec

    def add_edge(self, u: int, v: int, label: str,
                 directed: bool = False) -> DeltaRecord:
        with self._lock:
            u, v = int(u), int(v)
            for g in (u, v):
                if not (0 <= g < len(self._assign)):
                    raise ValueError(f"edge endpoint gid {g} out of range")
                if self._graph.node_vocab.str_of(
                        int(self._graph.node_label[g])) == DELETED_LABEL:
                    raise ValueError(f"gid {g} is deleted")
            touched = tuple(sorted({int(self._assign[u]),
                                    int(self._assign[v])}))
            return self._append(DeltaRecord(
                seq=self.max_seq() + 1, op=EDGE_ADD, u=u, v=v, label=label,
                directed=bool(directed), touched=touched))

    def del_edge(self, u: int, v: int, label: str) -> DeltaRecord:
        with self._lock:
            u, v = int(u), int(v)
            touched = tuple(sorted({int(self._assign[u]),
                                    int(self._assign[v])}))
            return self._append(DeltaRecord(
                seq=self.max_seq() + 1, op=EDGE_DEL, u=u, v=v, label=label,
                touched=touched))

    def add_vertex(self, label: str, value: float = math.nan,
                   pid: Optional[int] = None) -> DeltaRecord:
        with self._lock:
            if pid is None:   # least-loaded partition under the overlay
                pid = int(np.argmin(np.bincount(
                    self._assign[self._assign >= 0], minlength=self.k)))
            gid = int(self._graph.n_nodes)
            return self._append(DeltaRecord(
                seq=self.max_seq() + 1, op=VERTEX_ADD, u=gid, label=label,
                value=float(value), pid=int(pid), touched=(int(pid),)))

    def del_vertex(self, gid: int) -> DeltaRecord:
        with self._lock:
            gid = int(gid)
            esrc = np.asarray(self._graph.edge_src)
            edst = np.asarray(self._graph.edge_dst)
            nbrs = np.concatenate([edst[esrc == gid], esrc[edst == gid]])
            touched = {int(self._assign[gid])}
            touched |= {int(self._assign[n]) for n in nbrs}
            return self._append(DeltaRecord(
                seq=self.max_seq() + 1, op=VERTEX_DEL, u=gid,
                touched=tuple(sorted(touched))))

    def apply_op(self, d: Dict[str, Any]) -> DeltaRecord:
        """Dict-shaped mutation entry point (serve.py's mutate workload):
        ``{"op": "edge_add", "u": 3, "v": 9, "label": "knows"}`` etc."""
        op = d.get("op")
        if op == EDGE_ADD:
            return self.add_edge(d["u"], d["v"], d["label"],
                                 bool(d.get("directed", False)))
        if op == EDGE_DEL:
            return self.del_edge(d["u"], d["v"], d["label"])
        if op == VERTEX_ADD:
            return self.add_vertex(d["label"],
                                   float(d.get("value", math.nan)),
                                   d.get("pid"))
        if op == VERTEX_DEL:
            return self.del_vertex(d["u"])
        raise ValueError(f"unknown delta op {op!r}")

    # -- snapshots & pins ----------------------------------------------------

    def snapshot(self) -> GenerationView:
        """The current generation + pending records, pinned against GC
        until ``release()``."""
        with self._lock:
            view = GenerationView(self, self.catalog, tuple(self._records),
                                  self._graph, self._assign, self.max_seq())
            return view.pin()

    def pin(self, view: GenerationView) -> None:
        with self._lock:
            ent = self._pins.setdefault(id(view), [view, 0])
            ent[1] += 1

    def unpin(self, view: GenerationView) -> None:
        with self._lock:
            ent = self._pins.get(id(view))
            if ent is None:
                return
            ent[1] -= 1
            if ent[1] <= 0:
                del self._pins[id(view)]

    def pinned_files(self) -> set:
        with self._lock:
            out: set = set()
            for view, _ in self._pins.values():
                out |= view.files()
            return out

    def gc(self) -> int:
        """Remove content-addressed files no longer referenced by the
        live manifest or any pinned view."""
        with self._lock:
            keep = ({p["shard"] for p in self.catalog.manifest["partitions"]}
                    | {self.catalog.graph_file} | self.pinned_files())
            return gc_directory(self.path, keep)

    # -- compaction ----------------------------------------------------------

    def compact(self, pid: int) -> int:
        """Fold the pending history into partition ``pid``'s shard and the
        whole-graph file, publish generation+1 (one atomic manifest
        rename), trim the logs, GC — returns the new generation.

        Ordering is the crash-safety argument, executed through the
        fault-pointed helpers so the crash sweep of
        tests/test_torch_mutation.py can stop it anywhere: (1) new shard
        (content-addressed — the old one is untouched), (2) new graph file (ditto), (3) manifest rename (THE
        publish), (4) log trim, (5) GC.  Crash before (3): the old
        manifest still pairs the old shard + old graph file + intact
        logs.  Crash after (3): the new generation is live and steps
        (4)/(5) re-run idempotently at the next open.
        """
        with self._lock, \
                self.tracer.span("deltas.compact", pid=int(pid),
                                 generation=int(self.generation)) as _csp:
            pid = int(pid)
            _csp.set(pending=int(self.pending_counts()[pid]))
            view = GenerationView(self, self.catalog, tuple(self._records),
                                  self._graph, self._assign, self.max_seq())
            view._ensure_geometry()
            g = view.graph
            m = self.catalog.manifest

            # (1) the folded shard for pid (a no-op rewrite when clean —
            # same content key — but geometry growth changes the key)
            arrs, g2l = view.load_bundle(pid)
            arrs = dict(arrs)
            arrs["g2l"] = g2l
            checksums = {k: array_checksum(v) for k, v in arrs.items()}
            fname = shard_name(pid, _content_key(checksums))
            if not os.path.exists(os.path.join(self.path, fname)):
                _atomic_savez(os.path.join(self.path, fname), arrs)

            # (2) the folded whole-graph file
            garrs = dict(node_label=np.asarray(g.node_label),
                         node_value=np.asarray(g.node_value),
                         edge_src=np.asarray(g.edge_src),
                         edge_dst=np.asarray(g.edge_dst),
                         edge_label=np.asarray(g.edge_label),
                         edge_directed=np.asarray(g.edge_directed),
                         assignment=view.assignment.astype(np.int32))
            graph_checksums = {k: array_checksum(v) for k, v in garrs.items()}
            graph_file = graph_file_name(graph_checksums)
            if not os.path.exists(os.path.join(self.path, graph_file)):
                _atomic_savez(os.path.join(self.path, graph_file), garrs)

            # (3) the manifest: pid's entry refolded, the rest describing
            # their (untouched) shards; geometry/vocabs/counts from the
            # overlay — the single publish point
            core_mask = view.assignment == pid
            hist_labels = np.asarray(g.node_label)[core_mask]
            new_meta = {
                "pid": pid,
                "shard": fname,
                "n_core": int(core_mask.sum()),
                "n_nodes": int(np.asarray(arrs["node_gid"] >= 0).sum()),
                "n_edges": int(np.asarray(arrs["ell_dst"] >= 0).sum()),
                "nbytes": int(sum(np.asarray(v).nbytes
                                  for v in arrs.values())),
                "components": int(
                    view._rebuilt.connected_components_per_partition()[pid]
                    if view._rebuilt is not None
                    else m["partitions"][pid]["components"]),
                "label_histogram": _label_histogram(hist_labels),
                "checksums": checksums,
            }
            seq = view.seq
            shard_seq = [self.catalog.shard_seq(p) for p in range(self.k)]
            shard_seq[pid] = seq
            partitions = [new_meta if p["pid"] == pid else p
                          for p in m["partitions"]]
            manifest = dict(m)
            manifest.update({
                "generation": self.generation + 1,
                "applied_seq": seq,
                "shard_seq": shard_seq,
                "graph_file": graph_file,
                "graph_checksums": graph_checksums,
                "node_pad": view.node_pad,
                "edge_pad": view.edge_pad,
                "ell_width": view.ell_width,
                "cut_edges": view.cut_edges(),
                "n_nodes": int(g.n_nodes),
                "n_edges": int(g.n_edges),
                "node_vocab": [g.node_vocab.str_of(i)
                               for i in range(len(g.node_vocab))],
                "edge_vocab": [g.edge_vocab.str_of(i)
                               for i in range(len(g.edge_vocab))],
                "partitions": partitions,
            })
            write_manifest(self.path, manifest)

            # the new generation is live
            self.catalog = DiskCatalog(self.path, self.verify_checksums)
            self.compactions += 1
            _csp.set(new_generation=int(self.generation))
            # (4) trim folded records, (5) GC unpinned superseded files
            self.log.trim(self.catalog.applied_seq,
                          [self.catalog.shard_seq(p)
                           for p in range(self.k)])
            self._records = [
                r for r in self._records
                if not (r.seq <= self.catalog.applied_seq
                        and all(r.seq <= self.catalog.shard_seq(p)
                                for p in r.touched))]
            self.gc()
            return self.generation

    def compact_all(self) -> int:
        """Fold every partition (k publishes); returns the generation."""
        gen = self.generation
        for pid in range(self.k):
            gen = self.compact(pid)
        return gen

    def resave(self, pg: PartitionedGraph) -> Dict[str, Any]:
        """Publish a full re-save (e.g. a repartitioned layout) as the
        next generation of THIS directory: every pending record is folded
        (``pg`` must already reflect the overlay graph), logs clear, and
        pinned generations' files survive GC."""
        with self._lock:
            seq = self.max_seq()
            manifest = save_partitioned_graph(
                pg, self.path, generation=self.generation + 1,
                applied_seq=seq, shard_seq=[seq] * pg.k,
                keep_files=self.pinned_files())
            self.catalog = DiskCatalog(self.path, self.verify_checksums)
            self.log.trim(seq, [seq] * self.catalog.k)
            self._records = []
            self._graph = self.catalog.load_graph()
            self._assign = np.asarray(self.catalog.assignment,
                                      dtype=np.int32)
            return manifest


def open_mutable(path: str, verify_checksums: bool = True
                 ) -> MutableGraphDirectory:
    return MutableGraphDirectory(path, verify_checksums)
