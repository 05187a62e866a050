"""The PyTorch port's out-of-core storage (``repro_torch.storage`` and the
store's disk backing) against the JAX package's, on the CPU.

Both packages save the same partitioned graph (carried over with
``repro_torch.convert``) into graph directories of their own, module-scoped
and shared by every test here.  They must write the same shard file names
and checksums, and each must open the other's directory.  A port session
opened out of core must then equal the reference's ``GraphSession.open``
exactly: answers, the ``loads`` sequence, ``iterations`` and every
``LoadStats`` field, per query and for ``submit_many``, at ``cache_parts=1``
and ``host_cache_parts`` 1 and 2.  One reference and one port session per
(engine, host capacity) serve every heuristic in turn, so retracing stays
cheap and the residency state each query meets is the same on both sides.
MapReduceMP at k = 4 needs four devices in the reference, so its side runs
once in a subprocess with four forced host devices.
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import build_partitions as ref_build_partitions
from repro.core import match_disjunctive, partition_graph as ref_partition_graph
from repro.data.generators import subgen_like_graph as ref_subgen_graph
from repro.data.generators import subgen_queries as ref_subgen_queries
from repro.storage import DiskCatalog as RefDiskCatalog
from repro.storage import HostShardCache as RefHostShardCache

import repro_torch.core as tc
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.core.engine import part_to_device_dict
from repro_torch.data.generators import subgen_queries
from repro_torch.storage import (DiskCatalog, HostShardCache,
                                 OutOfCorePartitionedGraph, StorageFormatError,
                                 array_checksum, save_partitioned_graph)
from repro_torch.storage import format as storage_format

CAP = 4096
HEURISTICS = ("max-sn", "min-sn", "random-sn")
MR_HEURISTICS = ("max-sn", "min-sn", "max-yield")
HOST_PARTS = (1, 2)

MR_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from repro.core import EngineConfig, GraphSession
    from repro.data.generators import subgen_queries

    gdir = sys.argv[1]
    CAP, HEURISTICS, HOST_PARTS = {consts}
    out = {{}}
    for h in HEURISTICS:
        for hc in HOST_PARTS:
            sess = GraphSession.open(gdir, engine="mapreduce", heuristic=h,
                                     seed=1, cache_parts=1,
                                     host_cache_parts=hc,
                                     config=EngineConfig(cap=CAP))
            dqs = subgen_queries(sess.graph)
            runs = []
            for dq in dqs:
                r = sess.submit(dq)
                runs.append({{"answers": r.answers.tolist(),
                             "iterations": r.reports[0].stats.iterations,
                             "load_stats": r.load_stats.to_dict(),
                             "generation": r.generation}})
            rep = sess.submit_many(dqs, max_answers=[None, 2, None])
            out[f"{{h}}/{{hc}}"] = {{
                "submit": runs,
                "many": [{{"answers": r.answers.tolist(),
                          "load_stats": r.load_stats.to_dict()}}
                         for r in rep.results],
                "many_stats": rep.load_stats.to_dict(),
                "session": sess.load_stats.to_dict()}}
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)
""").format(consts=repr((CAP, MR_HEURISTICS, HOST_PARTS)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite
    runs several test processes at once, and idle worker threads would
    only contend with them.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vocab(v):
    return [v.str_of(i) for i in range(len(v))]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference graph and pg, their port twins, the queries of both,
    the oracle answers, and a graph directory saved by each package."""
    g = ref_subgen_graph(n_nodes=250, n_edges=700, n_embed=10, seed=3)
    pg = ref_build_partitions(g, ref_partition_graph(g, 4, "kway_shem"), 4,
                              scheme="kway_shem")
    tg = graph_from_arrays(node_label=g.node_label, node_value=g.node_value,
                           edge_src=g.edge_src, edge_dst=g.edge_dst,
                           edge_label=g.edge_label,
                           edge_directed=g.edge_directed,
                           node_vocab=_vocab(g.node_vocab),
                           edge_vocab=_vocab(g.edge_vocab))
    tpg = partitioned_graph_from_arrays(tg, pg.assignment, 4, "kway_shem")
    dqs, tdqs = ref_subgen_queries(g), subgen_queries(tg)
    refs = {dq.name: match_disjunctive(g, dq, q_pad=8) for dq in dqs}
    root = tmp_path_factory.mktemp("graph-dirs")
    ref_dir, port_dir = str(root / "ref"), str(root / "port")
    RefSession(pg=pg).save(ref_dir)
    manifest = tc.GraphSession(pg=tpg, device="cpu").save(port_dir)
    return dict(g=g, pg=pg, tg=tg, tpg=tpg, dqs=dqs, tdqs=tdqs, refs=refs,
                ref_dir=ref_dir, port_dir=port_dir, manifest=manifest)


def _same_bundle(got, want) -> bool:
    """A bundle's arrays equal the numpy bundle's byte for byte (scalars,
    held as Python ints, in the numpy scalar's dtype)."""
    return set(got) == set(want) and all(
        np.asarray(got[k], dtype=np.asarray(want[k]).dtype).tobytes()
        == np.asarray(want[k]).tobytes() for k in want)


def _corrupt(path, key, fn):
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    arrs[key] = arrs[key].copy()
    fn(arrs[key])
    np.savez(path, **arrs)


# ---------------------------------------------------------------------------
# format: shards, manifest, checksums
# ---------------------------------------------------------------------------

def test_shard_round_trip_bit_identical(setup):
    """Every partition's arrays survive the disk round trip byte for byte
    (dtype, shape and content)."""
    tpg = setup["tpg"]
    cat = DiskCatalog(setup["port_dir"])
    for pid in range(tpg.k):
        part, g2l = cat.read_part(pid)
        want = part_to_device_dict(tpg.parts[pid])
        assert set(part) == set(want)
        for k in want:
            a, b = np.asarray(part[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, (pid, k)
            assert a.tobytes() == b.tobytes(), (pid, k)
        assert np.asarray(g2l).tobytes() == tpg.g2l[pid].tobytes()


def test_manifest_and_catalog_metrics(setup):
    tpg, manifest = setup["tpg"], setup["manifest"]
    assert manifest["format_version"] == 1 and manifest["generation"] == 0
    assert (manifest["k"], manifest["scheme"]) == (4, "kway_shem")
    assert (manifest["node_pad"], manifest["ell_width"], manifest["cut_edges"]) == \
        (tpg.node_pad, tpg.ell_width, tpg.cut_edges)
    cat = DiskCatalog(setup["port_dir"])
    assert np.array_equal(cat.components_per_partition(),
                          tpg.connected_components_per_partition())
    for pid in range(tpg.k):
        meta = cat.part_meta(pid)
        assert meta["n_core"] == tpg.parts[pid].n_core
        assert meta["n_nodes"] == tpg.parts[pid].n_nodes
        assert meta["nbytes"] > 0
        assert sum(dict(map(tuple, meta["label_histogram"])).values()) == \
            tpg.parts[pid].n_core
    assert cat.total_part_bytes() == sum(cat.part_nbytes(p) for p in range(4))
    # the SNI inputs come from the manifest (plus the O(V) node arrays for
    # value predicates) and equal the in-RAM counts; the opened pg mirrors
    # the in-RAM one with no partition in memory
    from repro_torch.core.graph import WILDCARD
    from repro_torch.core.query import OP_GT
    ooc = OutOfCorePartitionedGraph(cat)
    assert ooc.parts == [] and ooc.g2l is None
    assert (ooc.k, ooc.scheme, ooc.node_pad, ooc.ell_width) == \
        (tpg.k, tpg.scheme, tpg.node_pad, tpg.ell_width)
    assert np.array_equal(ooc.owner, tpg.owner)
    labels = [WILDCARD, -3] + sorted({int(lb) for lb in setup["tg"].node_label})[:6]
    for lid in labels:
        assert np.array_equal(ooc.start_label_counts(lid),
                              tpg.start_label_counts(lid)), lid
        assert np.array_equal(ooc.start_label_counts(lid, OP_GT, 0.5),
                              tpg.start_label_counts(lid, OP_GT, 0.5)), lid


def test_both_packages_write_the_same_directory(setup):
    """Content-addressed names: the same partitioned graph gives the same
    shard and graph file names and the same per-array checksums."""
    ref_dir, port_dir = setup["ref_dir"], setup["port_dir"]
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    a, b = RefDiskCatalog(ref_dir).manifest, DiskCatalog(port_dir).manifest
    assert a == b
    for fname in os.listdir(ref_dir):
        if fname.endswith(".npz"):
            with np.load(os.path.join(ref_dir, fname)) as x, \
                    np.load(os.path.join(port_dir, fname)) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    assert array_checksum(x[k]) == array_checksum(y[k]), (fname, k)


def test_checksum_catches_corruption(setup, tmp_path):
    gdir = str(tmp_path / "corrupt")
    save_partitioned_graph(setup["tpg"], gdir)
    _corrupt(DiskCatalog(gdir).shard_path(1), "node_label",
             lambda a: a.__setitem__(0, a[0] + 1))
    cat = DiskCatalog(gdir)
    with pytest.raises(StorageFormatError, match="checksum"):
        cat.read_part(1)
    cat.read_part(0)                                   # others still fine
    DiskCatalog(gdir, verify_checksums=False).read_part(1)
    with pytest.raises(StorageFormatError, match="manifest"):
        DiskCatalog(str(tmp_path))
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "manifest.json").write_text(json.dumps(
        {"kind": "pgqp-graph-dir", "format_version": 999}))
    with pytest.raises(StorageFormatError, match="format_version"):
        DiskCatalog(str(bad))


class _Crash(BaseException):
    pass


def _crash_at(n):
    """A fault hook that raises before the n-th durable op; returns the hook
    and the list of ops it saw."""
    seen = []

    def hook(step, path):
        seen.append((step, path))
        if len(seen) - 1 == n:
            raise _Crash(step, path)
    return hook, seen


def _assert_serves(cat, pg):
    for pid in range(pg.k):
        part, g2l = cat.read_part(pid)
        want = part_to_device_dict(pg.parts[pid])
        assert _same_bundle(part, want), pid
        assert np.asarray(g2l).tobytes() == pg.g2l[pid].tobytes(), pid


@pytest.mark.parametrize("resave", [False, True])
def test_interrupted_save_never_leaves_an_openable_directory(setup, tmp_path, resave):
    """A crash before any durable step (write, rename, unlink) of a first
    save leaves a directory that does not open.  Of a re-save with another
    layout, it leaves one that opens and serves, bit for bit, the old
    layout up to the manifest's rename and the new one after it."""
    tpg = setup["tpg"]
    other = partitioned_graph_from_arrays(setup["tg"], (tpg.assignment + 1) % 4, 4,
                                          "kway_shem")

    def scenario(gdir, n):
        old = save_partitioned_graph(tpg, gdir) if resave else None
        hook, seen = _crash_at(n)
        storage_format.fault_hook = hook
        try:
            new = save_partitioned_graph(other if resave else tpg, gdir)
        finally:
            storage_format.fault_hook = None
        return old, new, seen

    _, new, seen = scenario(str(tmp_path / "count"), -1)
    steps = [(step, os.path.basename(path)) for step, path in seen]
    publish = steps.index(("rename", "manifest.json"))
    assert {s for s, _ in steps} == ({"write", "rename", "unlink"} if resave
                                     else {"write", "rename"})
    for n in range(len(steps)):
        gdir = str(tmp_path / f"crash-{n}")
        with pytest.raises(_Crash):
            old, _, _ = scenario(gdir, n)
        if not resave:
            with pytest.raises(StorageFormatError, match="manifest"):
                DiskCatalog(gdir)
            continue
        cat = DiskCatalog(gdir)
        if n <= publish:
            assert cat.manifest["partitions"] != new["partitions"], n
            _assert_serves(cat, tpg)
        else:
            assert cat.manifest == new, n
            _assert_serves(cat, other)


# ---------------------------------------------------------------------------
# the host LRU tier
# ---------------------------------------------------------------------------

def test_host_cache_lru_and_demand_reads(setup):
    stats = tc.LoadStats()
    tier = HostShardCache(DiskCatalog(setup["port_dir"]), stats, capacity_parts=2)
    b0 = tier.get(0)
    assert stats.disk_reads == 1 and stats.bytes_disk == b0.nbytes
    assert tier.get(0) is b0                        # host hit: no new read
    assert stats.disk_reads == 1 and stats.bytes_host == 2 * b0.nbytes
    tier.get(1)
    tier.get(0)                                     # refresh 0
    tier.get(2)                                     # evicts 1 (LRU)
    assert stats.host_evictions == 1
    assert tier.resident(0) and tier.resident(2) and not tier.resident(1)
    tier.get(1)                                     # re-read costs disk again
    assert stats.disk_reads == 4
    assert tier.peak_nbytes <= 2 * max(tier.nbytes(p) for p in range(4))
    with pytest.raises(ValueError):
        HostShardCache(DiskCatalog(setup["port_dir"]), tc.LoadStats(), capacity_parts=0)


def test_host_cache_read_ahead(setup):
    """A read-ahead counts its disk read when issued; the get that joins it
    is a read-ahead hit and returns the shard bit for bit."""
    stats = tc.LoadStats()
    cat = DiskCatalog(setup["port_dir"])
    tier = HostShardCache(cat, stats, capacity_parts=4)
    assert tier.read_ahead(3) is True
    assert tier.read_ahead(3) is False              # already in flight
    assert (stats.disk_reads, stats.read_ahead_issued, stats.bytes_disk) == \
        (1, 1, cat.part_nbytes(3))
    got = tier.get(3)
    assert stats.read_ahead_hits == 1
    assert _same_bundle(got.part, part_to_device_dict(setup["tpg"].parts[3]))
    assert got.g2l.dtype == torch.int32 and not got.g2l.is_pinned()
    assert tier.read_ahead(3) is False              # resident now
    tier.get(3)
    assert stats.read_ahead_hits == 1               # only the first get
    off = HostShardCache(cat, tc.LoadStats(), read_ahead=False)
    assert off.read_ahead(0) is False


def test_read_ahead_failure_surfaces_real_error(setup, tmp_path):
    """A corrupt shard read on the worker thread re-raises the real
    StorageFormatError at the next get(), and the next get retries."""
    gdir = str(tmp_path / "ra-corrupt")
    save_partitioned_graph(setup["tpg"], gdir)
    cat = DiskCatalog(gdir)
    _corrupt(cat.shard_path(2), "node_value", lambda a: a.__setitem__(0, 123.0))
    tier = HostShardCache(cat, tc.LoadStats())
    assert tier.read_ahead(2) is True
    with pytest.raises(StorageFormatError, match="checksum"):
        tier.get(2)
    assert not tier.resident(2)
    with pytest.raises(StorageFormatError, match="checksum"):
        tier.get(2)


def test_unconsumed_read_ahead_stays_within_host_budget(setup):
    """Read-aheads nobody gets hold their slots in the LRU itself: bounded
    by the host budget, evictions counted when issued, every worker
    finished after clear()."""
    stats = tc.LoadStats()
    cat = DiskCatalog(setup["port_dir"])
    tier = HostShardCache(cat, stats, capacity_parts=2)
    for pid in (0, 1, 2, 3):
        assert tier.read_ahead(pid) is True
    assert stats.host_evictions == 2 and list(tier._cache) == [2, 3]
    assert tier.peak_nbytes <= 2 * max(cat.part_nbytes(p) for p in range(4))
    tier.get(3)
    assert stats.read_ahead_hits == 1
    tier.get(0)                                     # evicted slot: a demand read
    assert stats.disk_reads == 5 and stats.read_ahead_hits == 1
    workers = list(tier._workers)
    tier.clear()
    assert not any(t.is_alive() for t in workers) and not tier._cache


def test_read_ahead_counters_do_not_depend_on_worker_timing(setup):
    """Every counter and the LRU order are kept on the calling thread: one
    random sequence of read-aheads and gets over a two-partition tier gives
    the same LoadStats and the same bundles whether the workers finish at
    once or late (random sleeps in the shard read), with the interpreter
    switching threads every microsecond."""
    class JitteryCatalog:
        def __init__(self, inner, seed):
            self._inner = inner
            self._rng = np.random.default_rng(seed)
            self._lock = threading.Lock()

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def read_part(self, pid):
            with self._lock:
                delay = float(self._rng.random()) * 0.004
            time.sleep(delay)
            return self._inner.read_part(pid)

    cat = DiskCatalog(setup["port_dir"])
    ops = np.random.default_rng(11).integers(0, 8, size=300)
    runs = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for catalog in (cat, JitteryCatalog(cat, 1), JitteryCatalog(cat, 2)):
            stats = tc.LoadStats()
            tier = HostShardCache(catalog, stats, capacity_parts=2)
            seen = []
            deadline = time.time() + 60
            for op in ops:
                pid = int(op) % 4
                if op < 4:
                    seen.append(("ra", pid, tier.read_ahead(pid)))
                else:
                    seen.append(("get", pid, int(tier.get(pid).part["pid"])))
                assert time.time() < deadline
            workers = list(tier._workers)
            tier.clear()
            assert not any(t.is_alive() for t in workers)
            runs.append((stats.to_dict(), seen))
    finally:
        sys.setswitchinterval(interval)
    assert runs[0] == runs[1] == runs[2]
    stats, seen = runs[0]
    assert stats["read_ahead_hits"] > 0 and stats["host_evictions"] > 0
    assert all(got == pid for op, pid, got in seen if op == "get")


def test_prefetch_of_in_flight_read_ahead_does_not_block(setup):
    """store.prefetch of a pid whose read-ahead is still in flight returns
    without joining the worker (resident() counts landed bundles only)."""
    class SlowCatalog:
        def __init__(self, inner):
            self._inner = inner
            self.gate = threading.Event()

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def read_part(self, pid):
            self.gate.wait(timeout=10.0)
            return self._inner.read_part(pid)

    cat = DiskCatalog(setup["port_dir"])
    slow = SlowCatalog(cat)
    store = tc.PartitionStore(OutOfCorePartitionedGraph(cat), backing=slow,
                              host_cache_parts=2, device="cpu")
    assert store.prefetch(1) is True                # read-ahead issued
    t0 = time.time()
    assert store.prefetch(1) is False               # no staging, no join
    assert time.time() - t0 < 5.0
    assert store.stats.read_ahead_issued == 1 and not store.contains(1)
    slow.gate.set()
    entry = store.get(1)
    assert store.stats.read_ahead_hits == 1
    assert _same_bundle(entry.part, part_to_device_dict(setup["tpg"].parts[1]))


def test_store_three_tier_fall_through(setup):
    """Device miss -> host -> disk: a bounded device cache over a bounded
    host cache pays disk reads on re-staging, and prefetch() of a
    non-host-resident partition becomes a read-ahead and no device copy."""
    cat = DiskCatalog(setup["port_dir"])
    store = tc.PartitionStore(OutOfCorePartitionedGraph(cat), capacity_parts=1,
                              backing=cat, host_cache_parts=1, device="cpu")
    assert store.host_tier.part_keys == list(part_to_device_dict(setup["tpg"].parts[0]))
    assert store.host_nbytes(2) == cat.part_nbytes(2)
    store.get(0)
    assert store.stats.disk_reads == 1 and store.stats.misses == 1
    store.get(0)                                    # device warm: no traffic
    assert store.stats.hits == 1 and store.stats.disk_reads == 1
    store.get(1)                                    # evicts 0 in BOTH tiers
    store.get(0)                                    # full fall-through again
    assert store.stats.disk_reads == 3
    assert store.stats.evictions >= 1 and store.stats.host_evictions >= 1
    assert store.prefetch(2) is True
    assert store.stats.read_ahead_issued == 1 and not store.contains(2)
    entry = store.get(2)
    assert store.stats.read_ahead_hits == 1 and store.stats.prefetch_issued == 0
    assert _same_bundle(entry.part, part_to_device_dict(setup["tpg"].parts[2]))
    # clear() drops the device tier only; close() both
    store.clear()
    assert not store.contains(2) and store.host_tier.resident(2)
    store.close()
    assert not store.host_tier.resident(2)


@pytest.mark.parametrize("host_parts", HOST_PARTS)
def test_store_stacked_entries_from_disk(setup, host_parts):
    """Stacked bundles (TraditionalMP's, MapReduceMP's) stage through a host
    tier smaller than the stack, padding duplicates included, identical to
    the in-RAM stack."""
    cat = DiskCatalog(setup["port_dir"])
    store = tc.PartitionStore(OutOfCorePartitionedGraph(cat), backing=cat,
                              host_cache_parts=host_parts, device="cpu")
    ram = tc.PartitionStore(setup["tpg"], device="cpu")
    for key in ((2, 0, 1), (3, 3), (0, 1, 2, 3)):
        a, b = store.get_stacked(key), ram.get_stacked(key)
        for k in b.part:
            assert np.asarray(a.part[k]).tobytes() == np.asarray(b.part[k]).tobytes(), k
        assert np.asarray(a.g2l).tobytes() == np.asarray(b.g2l).tobytes()
    assert store.stats.bytes_host == sum(cat.part_nbytes(p)
                                         for p in (2, 0, 1, 3, 3, 0, 1, 2, 3))
    assert store.host_tier.peak_nbytes <= host_parts * max(
        cat.part_nbytes(p) for p in range(4))


# ---------------------------------------------------------------------------
# opened sessions against the reference's GraphSession.open
# ---------------------------------------------------------------------------

def _same_result(a, b, name):
    np.testing.assert_array_equal(a.answers, b.answers, err_msg=name)
    assert a.load_stats.to_dict() == b.load_stats.to_dict(), name
    assert a.generation == b.generation == 0, name
    assert [r.stats.loads for r in a.reports] == [r.stats.loads for r in b.reports], name
    assert [r.stats.iterations for r in a.reports] == \
        [r.stats.iterations for r in b.reports], name


def _joined(read_ahead, workers):
    def issue_and_join(self, *args, **kwargs):
        issued = read_ahead(self, *args, **kwargs)
        for t in workers(self):
            t.join(timeout=60)
        return issued
    return issue_and_join


def _ref_workers(tier):
    with tier._lock:
        return list(tier._pending.values())


@pytest.fixture
def read_aheads_land_at_once(monkeypatch):
    """Both packages' read-aheads join their worker before returning.  The
    reference's worker inserts into its LRU when it lands, so under load
    its eviction order (and so its later disk reads) can follow thread
    timing; the port's order never does (test_read_ahead_counters_do_not_
    depend_on_worker_timing), but whether a landed read-ahead counts as
    host-resident does, in both.  Landing at once fixes both to the order
    of a worker that finishes first, as it does on an idle machine."""
    monkeypatch.setattr(RefHostShardCache, "read_ahead",
                        _joined(RefHostShardCache.read_ahead, _ref_workers))
    monkeypatch.setattr(HostShardCache, "read_ahead",
                        _joined(HostShardCache.read_ahead, lambda t: list(t._workers)))


@pytest.mark.parametrize("host_parts", HOST_PARTS)
@pytest.mark.parametrize("engine", ["opat", "traditional"])
def test_opened_session_matches_reference_open(setup, read_aheads_land_at_once, engine,
                                               host_parts):
    """Each package opens the OTHER's directory; every heuristic's submits,
    then submit_many, agree exactly (answers, loads, iterations, every
    LoadStats field), with real disk traffic and, on OPAT, read-ahead."""
    kw = dict(engine=engine, seed=1, processors=2, cache_parts=1,
              host_cache_parts=host_parts)
    ref = RefSession.open(setup["port_dir"], config=RefConfig(cap=CAP), **kw)
    port = tc.GraphSession.open(setup["ref_dir"], config=tc.EngineConfig(cap=CAP),
                                device="cpu", **kw)
    assert port.out_of_core and port.mutable and port.generation == 0
    assert port.pg.parts == [] and port.k == 4 and port.scheme == "kway_shem"
    for h in HEURISTICS:
        for dq, tdq in zip(setup["dqs"], setup["tdqs"]):
            a, b = port.submit(tdq, heuristic=h), ref.submit(dq, heuristic=h)
            _same_result(a, b, (h, dq.name))
            assert np.array_equal(a.answers, setup["refs"][dq.name])
            if engine == "opat":
                assert tc.validate_run_residency(a.reports[0].stats) is not None
    got = port.submit_many(setup["tdqs"], max_answers=[None, 2, None])
    want = ref.submit_many(setup["dqs"], max_answers=[None, 2, None])
    assert (got.loads, got.batch_sizes) == (want.loads, want.batch_sizes)
    assert got.load_stats.to_dict() == want.load_stats.to_dict()
    for a, b in zip(got.results, want.results):
        _same_result(a, b, ("many", a.name))
    st = port.load_stats
    assert st.to_dict() == ref.load_stats.to_dict()
    assert st.disk_reads > 0 and st.host_evictions > 0
    if engine == "opat":
        assert st.read_ahead_hits > 0
    assert port.store.host_tier.peak_nbytes <= host_parts * max(
        port.pg.backing.part_nbytes(p) for p in range(4))
    prof = port.workload_profile()
    assert prof["out_of_core"] is True and prof["cache"] == st.to_dict()
    # both open a mutable directory: the profiles carry the delta log's
    # keys, with nothing pending
    want_prof = ref.workload_profile()
    assert prof["pending_deltas"] == 0 and prof["compactions"] == 0
    assert prof == want_prof


@pytest.fixture(scope="module")
def mr_reference(setup, tmp_path_factory):
    """The reference's opened MapReduceMP sessions (four forced host
    devices), from one subprocess."""
    out = tmp_path_factory.mktemp("mr-open") / "ref.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", MR_SCRIPT, setup["port_dir"], str(out)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("host_parts", HOST_PARTS)
@pytest.mark.parametrize("heuristic", MR_HEURISTICS)
def test_opened_mapreduce_matches_reference_open(setup, mr_reference, heuristic,
                                                 host_parts):
    """MapReduceMP opened out of core: one stacked load of all four shards a
    cold run, through a host tier smaller than k; answers, iterations and
    every LoadStats field equal the reference's, per query and for the
    sequential submit_many drain."""
    want = mr_reference[f"{heuristic}/{host_parts}"]
    port = tc.GraphSession.open(setup["ref_dir"], engine="mapreduce",
                                heuristic=heuristic, seed=1, cache_parts=1,
                                host_cache_parts=host_parts,
                                config=tc.EngineConfig(cap=CAP), device="cpu")
    for tdq, w in zip(setup["tdqs"], want["submit"]):
        res = port.submit(tdq)
        assert res.answers.tolist() == w["answers"], tdq.name
        assert res.reports[0].stats.iterations == w["iterations"], tdq.name
        assert res.load_stats.to_dict() == w["load_stats"], tdq.name
        assert res.generation == w["generation"] == 0
    rep = port.submit_many(setup["tdqs"], max_answers=[None, 2, None])
    assert rep.load_stats.to_dict() == want["many_stats"]
    for r, w in zip(rep.results, want["many"]):
        assert r.answers.tolist() == w["answers"], r.name
        assert r.load_stats.to_dict() == w["load_stats"], r.name
    assert port.load_stats.to_dict() == want["session"]
    assert port.load_stats.disk_reads >= 4


def test_opened_mapreduce_random_sn_matches_oracle(setup):
    """RANDOM-SN gated below P draws from the port's own generator (a
    documented difference from the reference): held to the oracle."""
    port = tc.GraphSession.open(setup["port_dir"], engine="mapreduce",
                                heuristic="random-sn", host_cache_parts=1,
                                config=tc.EngineConfig(cap=CAP), device="cpu")
    gated = tc.MapReduceMPEngine(port.pg, port.config, m_limit=2,
                                 heuristic="random-sn", store=port.store)
    for tdq in setup["tdqs"]:
        plan = tc.generate_plan(tdq.disjuncts[0], port.graph, port.catalog)
        np.testing.assert_array_equal(gated.run(plan, seed=3).answers,
                                      setup["refs"][tdq.name], err_msg=tdq.name)
    assert port.load_stats.disk_reads == 4


def test_opened_session_save_streams_shards(setup, tmp_path):
    """save() of a disk-opened session copies every shard through the
    backing, bit for bit, under the same names."""
    port = tc.GraphSession.open(setup["port_dir"], host_cache_parts=1, device="cpu")
    copy_dir = str(tmp_path / "copy")
    manifest = port.save(copy_dir)
    assert manifest["partitions"] == setup["manifest"]["partitions"]
    assert manifest["generation"] == 0
    assert sorted(os.listdir(copy_dir)) == sorted(os.listdir(setup["port_dir"]))
