"""On-disk partition storage: a versioned shard-per-partition layout.

The paper's founding premise is a graph too large for main memory, and
its partitioned representation is exactly the unit that makes disk
residency natural: every partition is already a fixed-geometry array
bundle (core/graph.py), so the storage layer can treat "one partition"
as "one shard file" and never needs to understand traversal semantics.
Averbuch & Neumann (arXiv:1301.5121) make the case that partitioned graph
stores live or die by their on-disk layout and cache behaviour; this
module is the layout half (the cache half is storage/host_cache.py).

A *graph directory* written by ``save_partitioned_graph`` holds:

  manifest.json     — format version, partition geometry (k, scheme,
                      node_pad / edge_pad / ell_width, cut_edges), the
                      label vocabularies, and a per-partition catalog:
                      shard file name, vertex / edge counts, connected
                      components, byte size, a core-node label histogram,
                      and a sha256 checksum per array.  Everything the
                      heuristics need to *rank* partitions (SNI counts,
                      MAX-YIELD admission) is derivable from the manifest
                      plus ``graph.npz`` — no shard needs to be resident.
  graph.npz         — the whole-graph host arrays (node labels / values,
                      edge lists, the [V] partition assignment).  O(V+E)
                      raw data; the padded, denormalized shard bundles
                      below are the memory hog this tier keeps on disk.
  part-<pid>-<key>.npz — one shard per partition: the evaluator input
                      dict (``part_to_device_dict`` arrays, ELLPACK
                      tiles included) plus that partition's g2l row.
                      Written uncompressed so a round trip is
                      bit-identical; ``<key>`` is a digest of the
                      arrays' checksums (content-addressed).

Durability: every file is written via temp + atomic rename, shard names
are content-addressed, and the manifest is written LAST.  A directory
without a manifest is simply not a graph directory, so an interrupted
first ``save`` can never be opened; an interrupted RE-save leaves the
old manifest naming the old (untouched) shard generation, so the old
layout stays fully servable — changed shards land under new names, and
superseded generations are garbage-collected only after the fresh
manifest is live.

``DiskCatalog`` opens a graph directory and serves shard reads (checksum
verified) plus the manifest-level metrics; ``OutOfCorePartitionedGraph``
is the ``PartitionedGraph`` the rest of the system sees — same fields and
methods, but ``parts`` is empty and partition bytes only ever enter
memory through the store's host/device cache tiers.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.graph import Graph, LabelVocab, PartitionedGraph, WILDCARD

FORMAT_VERSION = 1
FORMAT_KIND = "pgqp-graph-dir"
MANIFEST_NAME = "manifest.json"
GRAPH_NAME = "graph.npz"

# ---------------------------------------------------------------------------
# Fault injection (the crash tests of tests/test_torch_storage.py): every
# durable filesystem step in this module announces itself here BEFORE
# executing.  A test installs a hook
# that raises at step N to simulate a crash at that exact point; production
# leaves it None at zero cost.  Because every final file lands via atomic
# rename, "crash before step N" enumerates every observable intermediate
# on-disk state.
# ---------------------------------------------------------------------------

fault_hook: Optional[Callable[[str, str], None]] = None


def _fault_point(step: str, path: str) -> None:
    if fault_hook is not None:
        fault_hook(step, path)


class StorageFormatError(RuntimeError):
    """A graph directory is missing, unversioned, or fails verification."""


def shard_name(pid: int, content_key: str) -> str:
    """Shard file names are CONTENT-ADDRESSED (pid + a digest of the
    arrays' checksums): a re-save with changed content writes NEW files
    while the old manifest keeps naming the old ones, so an interrupted
    re-save can never mix layouts — the old directory stays fully live
    until the fresh manifest lands, and identical content maps to the
    identical (byte-identical) file."""
    return f"part-{int(pid):05d}-{content_key}.npz"


def _content_key(checksums: Dict[str, str]) -> str:
    h = hashlib.sha256()
    for k in sorted(checksums):
        h.update(k.encode())
        h.update(checksums[k].encode())
    return h.hexdigest()[:12]


def _atomic_savez(path: str, arrs: Dict[str, np.ndarray]) -> None:
    """Write an npz via temp file + rename, so a torn write can never be
    mistaken for a shard (np.savez appends '.npz' to bare names, hence
    the explicit file handle)."""
    tmp = path + ".tmp"
    _fault_point("write", path)
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    _fault_point("rename", path)
    os.replace(tmp, path)


def _atomic_write_text(path: str, text: str) -> None:
    """Text twin of ``_atomic_savez`` (manifests and delta logs)."""
    tmp = path + ".tmp"
    _fault_point("write", path)
    with open(tmp, "w") as f:
        f.write(text)
    _fault_point("rename", path)
    os.replace(tmp, path)


def graph_file_name(checksums: Dict[str, str]) -> str:
    """Whole-graph files are content-addressed like shards, so a re-save
    never overwrites the file the live manifest points at — the legacy
    fixed name ``graph.npz`` is still read (old directories) but never
    written by this build."""
    return f"graph-{_content_key(checksums)}.npz"


def array_checksum(a: np.ndarray) -> str:
    """sha256 over (dtype, shape, bytes) — shape/dtype are part of the
    identity so a reshaped or recast array never passes as unchanged."""
    a = np.ascontiguousarray(np.asarray(a))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def _shard_arrays(pg: PartitionedGraph, pid: int) -> Dict[str, np.ndarray]:
    """One partition's shard content: evaluator inputs + its g2l row."""
    from ..core.engine import part_to_device_dict
    arrs = {k: np.asarray(v) for k, v in part_to_device_dict(pg.parts[pid]).items()}
    arrs["g2l"] = np.asarray(pg.g2l[pid])
    return arrs


def _pad_axis(a: np.ndarray, n: int, fill, axis: int = 0) -> np.ndarray:
    if a.shape[axis] >= n:
        return a
    shape = list(a.shape)
    shape[axis] = n - a.shape[axis]
    pad = np.full(shape, fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=axis)


def pad_bundle(arrs: Dict[str, np.ndarray], node_pad: int, ell_width: int,
               n_nodes: int) -> Dict[str, np.ndarray]:
    """Grow a shard bundle to a target geometry with semantically inert
    padding (same fill values as core/graph.build_partitions): padded
    node rows have ``node_gid == -1`` and padded ELLPACK cells have
    ``ell_dst == -1``, which every evaluator predicate already gates on.
    The g2l row extends to the target vertex count with -1 (no new gid
    is ever local to a partition it doesn't touch).  Compaction (the JAX
    package's storage/deltas.py) publishes grown geometry in the manifest
    without rewriting untouched shards, so a shard may be stored smaller
    than the manifest geometry — this pads it back to uniform at read
    time, so a directory compacted there opens here."""
    out = dict(arrs)
    out["node_gid"] = _pad_axis(arrs["node_gid"], node_pad, -1)
    out["node_label"] = _pad_axis(arrs["node_label"], node_pad, -2)
    out["node_value"] = _pad_axis(arrs["node_value"], node_pad, np.nan)
    for k, fill in (("ell_dst", -1), ("ell_label", -2), ("ell_dir", 0),
                    ("ell_dlab", -2), ("ell_dval", np.nan),
                    ("ell_dgid", -1)):
        a = _pad_axis(arrs[k], ell_width, fill, axis=1)
        out[k] = _pad_axis(a, node_pad, fill, axis=0)
    out["g2l"] = _pad_axis(arrs["g2l"], n_nodes, -1)
    return out


def _label_histogram(node_label: np.ndarray) -> List[List[int]]:
    """Sparse [label_id, count] pairs over a partition's core nodes — the
    manifest-level SNI input (start-node counts per label)."""
    labels, counts = np.unique(node_label, return_counts=True)
    return [[int(l), int(c)] for l, c in zip(labels, counts) if l >= 0]


def save_partitioned_graph(pg: PartitionedGraph, path: str, *,
                           generation: Optional[int] = None,
                           applied_seq: Optional[int] = None,
                           shard_seq: Optional[List[int]] = None,
                           keep_files: Optional[set] = None
                           ) -> Dict[str, Any]:
    """Write ``pg`` as a graph directory; returns the manifest dict.

    Works for both in-RAM graphs (shards serialized from ``pg.parts``)
    and disk-opened ones (shards streamed partition-at-a-time through the
    backing catalog — never more than one partition's bytes in flight).
    The manifest is written last, so the directory only becomes openable
    once every shard it names is on disk.

    Generations: every manifest carries a monotone ``generation`` number
    (default: one past the directory's current manifest, 0 for a fresh
    directory) plus the delta-log watermark ``applied_seq`` / per-pid
    ``shard_seq`` (the JAX package's delta log).  ``keep_files`` names extra
    content-addressed files the post-publish GC must leave alone (shards
    and graph files still referenced by pinned generations).
    """
    assert pg.node_pad > 0, "uniform padding required (build_partitions default)"
    os.makedirs(path, exist_ok=True)
    backing: Optional[DiskCatalog] = getattr(pg, "backing", None)
    g = pg.graph
    prev_gen = -1
    prev_seq = 0
    if os.path.exists(os.path.join(path, MANIFEST_NAME)):
        try:
            with open(os.path.join(path, MANIFEST_NAME)) as f:
                prev = json.load(f)
            prev_gen = int(prev.get("generation", 0))
            prev_seq = int(prev.get("applied_seq", 0))
        except (OSError, ValueError):
            pass
    if generation is None:
        generation = prev_gen + 1
    if applied_seq is None:
        applied_seq = prev_seq
    if shard_seq is None:
        shard_seq = [int(applied_seq)] * pg.k

    parts_meta: List[Dict[str, Any]] = []
    part_keys: Optional[List[str]] = None
    for pid in range(pg.k):
        if backing is not None:
            arrs, g2l_row = backing.read_part(pid)
            arrs = dict(arrs)
            arrs["g2l"] = g2l_row
        else:
            arrs = _shard_arrays(pg, pid)
        checksums = {k: array_checksum(v) for k, v in arrs.items()}
        fname = shard_name(pid, _content_key(checksums))
        if not os.path.exists(os.path.join(path, fname)):
            _atomic_savez(os.path.join(path, fname), arrs)
        core_mask = pg.assignment == pid
        parts_meta.append({
            "pid": pid,
            "shard": fname,
            "n_core": int(core_mask.sum()),
            "n_nodes": int(np.asarray(arrs["node_gid"] >= 0).sum()),
            "n_edges": int(np.asarray(arrs["ell_dst"] >= 0).sum()),
            "nbytes": int(sum(np.asarray(v).nbytes for v in arrs.values())),
            "components": 0,   # filled below in one pass over all partitions
            "label_histogram": _label_histogram(
                np.asarray(g.node_label)[core_mask]),
            "checksums": checksums,
        })
        if part_keys is None:
            part_keys = [k for k in arrs.keys() if k != "g2l"]
    # one pass for the per-partition CC metric (paper Sec. 5.2) instead of
    # the accidental O(k^2) of calling it inside the loop above
    ccs = pg.connected_components_per_partition()
    for meta in parts_meta:
        meta["components"] = int(ccs[meta["pid"]])

    garrs = dict(node_label=np.asarray(g.node_label),
                 node_value=np.asarray(g.node_value),
                 edge_src=np.asarray(g.edge_src),
                 edge_dst=np.asarray(g.edge_dst),
                 edge_label=np.asarray(g.edge_label),
                 edge_directed=np.asarray(g.edge_directed),
                 assignment=pg.assignment.astype(np.int32))
    graph_checksums = {k: array_checksum(v) for k, v in garrs.items()}
    graph_file = graph_file_name(graph_checksums)
    # content-addressed: the old manifest's graph file is never overwritten
    # (a crash between here and the manifest rename leaves the previous
    # generation's pairing of manifest + graph arrays fully intact)
    if not os.path.exists(os.path.join(path, graph_file)):
        _atomic_savez(os.path.join(path, graph_file), garrs)

    manifest = {
        "kind": FORMAT_KIND,
        "format_version": FORMAT_VERSION,
        "scheme": pg.scheme,
        "k": pg.k,
        "generation": int(generation),
        "applied_seq": int(applied_seq),
        "shard_seq": [int(s) for s in shard_seq],
        "graph_file": graph_file,
        "graph_checksums": graph_checksums,
        "node_pad": int(pg.node_pad),
        "edge_pad": int(pg.edge_pad),
        "ell_width": int(pg.ell_width),
        "cut_edges": int(pg.cut_edges),
        "n_nodes": int(g.n_nodes),
        "n_edges": int(g.n_edges),
        "part_keys": part_keys,
        "node_vocab": [g.node_vocab.str_of(i) for i in range(len(g.node_vocab))],
        "edge_vocab": [g.edge_vocab.str_of(i) for i in range(len(g.edge_vocab))],
        "partitions": parts_meta,
    }
    write_manifest(path, manifest)
    # the manifest is live: garbage-collect content-addressed files no
    # manifest or pinned generation references any more
    live = {m["shard"] for m in parts_meta} | {graph_file}
    if keep_files:
        live |= set(keep_files)
    gc_directory(path, live)
    return manifest


def write_manifest(path: str, manifest: Dict[str, Any]) -> None:
    """Atomically publish ``manifest`` — THE commit point of every save
    and compaction.  Callers must have every file it names durable first."""
    _atomic_write_text(os.path.join(path, MANIFEST_NAME),
                       json.dumps(manifest, indent=2))


def gc_directory(path: str, keep: set) -> int:
    """Remove content-addressed files (``part-*.npz`` / ``graph-*.npz``)
    not in ``keep``.  Never touches the manifest, delta logs, or the
    legacy fixed-name ``graph.npz``.  Returns the number removed."""
    removed = 0
    for fname in sorted(os.listdir(path)):
        if fname in keep or fname == GRAPH_NAME:
            continue
        if (fname.startswith("part-") or fname.startswith("graph-")) \
                and fname.endswith(".npz"):
            _fault_point("unlink", os.path.join(path, fname))
            os.remove(os.path.join(path, fname))
            removed += 1
    return removed


class DiskCatalog:
    """An opened graph directory: manifest metrics + verified shard reads.

    The catalog itself holds only O(V) state (the manifest and, lazily,
    ``graph.npz``); partition shards are read on demand by the host cache
    tier (storage/host_cache.py).  ``verify_checksums`` (default on)
    checks every array's sha256 against the manifest at read time — a
    torn or corrupted shard raises ``StorageFormatError`` instead of
    silently producing wrong answers.
    """

    def __init__(self, path: str, verify_checksums: bool = True):
        self.path = path
        self.verify_checksums = verify_checksums
        mpath = os.path.join(path, MANIFEST_NAME)
        if not os.path.exists(mpath):
            raise StorageFormatError(f"{path!r} has no {MANIFEST_NAME} — "
                                     f"not a graph directory (or an "
                                     f"interrupted save)")
        with open(mpath) as f:
            self.manifest = json.load(f)
        if self.manifest.get("kind") != FORMAT_KIND:
            raise StorageFormatError(f"unrecognized manifest kind "
                                     f"{self.manifest.get('kind')!r}")
        version = self.manifest.get("format_version")
        if version != FORMAT_VERSION:
            raise StorageFormatError(f"format_version {version} not "
                                     f"supported (this build reads "
                                     f"{FORMAT_VERSION})")
        self._parts = {p["pid"]: p for p in self.manifest["partitions"]}
        if sorted(self._parts) != list(range(self.k)):
            raise StorageFormatError("manifest partition list is not "
                                     f"0..{self.k - 1}")
        self._global: Optional[Dict[str, np.ndarray]] = None
        # cumulative bytes this catalog read off disk (shard files, as
        # stored — before geometry padding); obs/metrics.py exports it as
        # repro_store_disk_bytes_total
        self.bytes_read: int = 0

    # -- manifest-level metadata -------------------------------------------

    @property
    def k(self) -> int:
        return int(self.manifest["k"])

    @property
    def scheme(self) -> str:
        return self.manifest["scheme"]

    @property
    def part_keys(self) -> List[str]:
        return list(self.manifest["part_keys"])

    @property
    def generation(self) -> int:
        """The manifest's publish generation (0 for pre-delta directories)."""
        return int(self.manifest.get("generation", 0))

    @property
    def applied_seq(self) -> int:
        """Delta records with seq <= this are already folded into the
        manifest's graph file and shards (the JAX package's delta log)."""
        return int(self.manifest.get("applied_seq", 0))

    def shard_seq(self, pid: int) -> int:
        """Per-partition fold watermark: records with seq <= this are
        baked into partition ``pid``'s shard file."""
        seqs = self.manifest.get("shard_seq")
        if seqs is None:
            return self.applied_seq
        return int(seqs[int(pid)])

    @property
    def graph_file(self) -> str:
        return self.manifest.get("graph_file", GRAPH_NAME)

    def part_meta(self, pid: int) -> Dict[str, Any]:
        return self._parts[int(pid)]

    def part_nbytes(self, pid: int) -> int:
        return int(self._parts[int(pid)]["nbytes"])

    def total_part_bytes(self) -> int:
        return sum(int(p["nbytes"]) for p in self.manifest["partitions"])

    def components_per_partition(self) -> np.ndarray:
        return np.asarray([self._parts[p]["components"]
                           for p in range(self.k)], dtype=np.int64)

    # -- whole-graph arrays (O(V+E), loaded once on first use) -------------

    def _globals(self) -> Dict[str, np.ndarray]:
        if self._global is None:
            with np.load(os.path.join(self.path, self.graph_file)) as z:
                arrs = {k: z[k] for k in z.files}
            want = self.manifest.get("graph_checksums")
            if self.verify_checksums and want:
                for k, a in arrs.items():
                    if array_checksum(a) != want.get(k):
                        raise StorageFormatError(
                            f"checksum mismatch on graph array {k!r} "
                            f"({self.graph_file}): file is corrupt or "
                            f"belongs to a different generation")
            self._global = arrs
        return self._global

    @property
    def assignment(self) -> np.ndarray:
        return self._globals()["assignment"]

    def load_graph(self) -> Graph:
        """Rebuild the host ``Graph`` (planner / oracle / profile input)."""
        g = self._globals()
        node_vocab, edge_vocab = LabelVocab(), LabelVocab()
        for s in self.manifest["node_vocab"]:
            node_vocab.intern(s)
        for s in self.manifest["edge_vocab"]:
            edge_vocab.intern(s)
        graph = Graph(
            n_nodes=int(self.manifest["n_nodes"]),
            node_label=g["node_label"], node_value=g["node_value"],
            edge_src=g["edge_src"], edge_dst=g["edge_dst"],
            edge_label=g["edge_label"], edge_directed=g["edge_directed"],
            node_vocab=node_vocab, edge_vocab=edge_vocab)
        graph.validate()
        return graph

    # -- the ranking input: SNI counts without any shard resident ----------

    def start_label_counts(self, label_id: int, value_op: int = 0,
                           value: float = 0.0) -> np.ndarray:
        """#core nodes matching (label, value predicate) per partition.

        Pure label queries are answered from the manifest's per-partition
        label histograms alone; value predicates additionally consult the
        O(V) ``graph.npz`` node arrays (through the same helper the
        in-RAM path uses, so semantics cannot diverge).  Partition shards
        are never read.
        """
        if not value_op:
            counts = np.zeros(self.k, dtype=np.int64)
            for pid in range(self.k):
                hist = self._parts[pid]["label_histogram"]
                if label_id == WILDCARD:
                    counts[pid] = sum(c for _, c in hist)
                else:
                    counts[pid] = next((c for l, c in hist
                                        if l == int(label_id)), 0)
            return counts
        from ..core.graph import start_label_counts_from_arrays
        g = self._globals()
        return start_label_counts_from_arrays(
            g["node_label"], g["node_value"], g["assignment"], self.k,
            label_id, value_op, value)

    # -- shard reads --------------------------------------------------------

    def shard_path(self, pid: int) -> str:
        return os.path.join(self.path, self._parts[int(pid)]["shard"])

    def read_part(self, pid: int) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """One shard off disk: (evaluator input dict, g2l row), checksum
        verified against the manifest when ``verify_checksums``.  Arrays
        are padded up to the manifest geometry after verification, so a
        directory whose compactions grew the padding still serves every
        shard at one uniform shape."""
        pid = int(pid)
        with np.load(self.shard_path(pid)) as z:
            arrs = {k: z[k] for k in z.files}
        self.bytes_read += sum(int(a.nbytes) for a in arrs.values())
        if self.verify_checksums:
            want = self._parts[pid]["checksums"]
            for k, a in arrs.items():
                got = array_checksum(a)
                if got != want.get(k):
                    raise StorageFormatError(
                        f"checksum mismatch on partition {pid} array "
                        f"{k!r} ({self.shard_path(pid)}): shard is "
                        f"corrupt or was written by a different layout")
        arrs = pad_bundle(arrs, int(self.manifest["node_pad"]),
                          int(self.manifest["ell_width"]),
                          int(self.manifest["n_nodes"]))
        g2l = arrs.pop("g2l")
        return arrs, g2l


class OutOfCorePartitionedGraph(PartitionedGraph):
    """A ``PartitionedGraph`` whose partition arrays live on disk.

    Same dataclass fields and methods as the in-RAM class — engines,
    sessions, and the scheduler are oblivious — except:

      * ``parts`` is empty and ``g2l`` is ``None``: partition bytes only
        enter memory through ``PartitionStore``'s host/device tiers
        (each shard carries its own g2l row);
      * ``start_label_counts`` / ``connected_components_per_partition``
        answer from the manifest catalog, so heuristic ranking and
        scheduler admission never touch a shard;
      * ``backing`` is the ``DiskCatalog`` the store reads shards from.
    """

    def __init__(self, catalog: DiskCatalog, graph: Optional[Graph] = None):
        m = catalog.manifest
        graph = graph if graph is not None else catalog.load_graph()
        assignment = np.asarray(catalog.assignment, dtype=np.int32)
        super().__init__(
            graph=graph, k=catalog.k, assignment=assignment, parts=[],
            owner=assignment.copy(), g2l=None,
            cut_edges=int(m["cut_edges"]),
            node_pad=int(m["node_pad"]), edge_pad=int(m["edge_pad"]),
            scheme=m["scheme"])
        self.backing = catalog
        self._ell_width = int(m["ell_width"])

    @property
    def ell_width(self) -> int:
        return self._ell_width

    def start_label_counts(self, label_id: int, value_op: int = 0,
                           value: float = 0.0) -> np.ndarray:
        return self.backing.start_label_counts(label_id, value_op, value)

    def connected_components_per_partition(self) -> np.ndarray:
        return self.backing.components_per_partition()


def open_partitioned_graph(path: str, verify_checksums: bool = True
                           ) -> OutOfCorePartitionedGraph:
    """Open a graph directory as an out-of-core ``PartitionedGraph``."""
    return OutOfCorePartitionedGraph(DiskCatalog(path, verify_checksums))
