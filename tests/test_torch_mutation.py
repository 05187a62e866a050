"""The PyTorch port's mutable graph directories (``repro_torch.storage.deltas``,
generation views in the store, the scheduler's generation pin and the
session's updates, compaction and fold) against the JAX package's, on the
CPU.

One graph directory, saved by the reference from the shared
``small_graph`` / ``small_pg`` fixtures, is copied for every test.  The
updates are built from the graph so that an answer of Q4 binds a vertex
added in the session (a clone of a bound vertex with the edges it has)
and so that the ELL width grows past the manifest's.  Both packages then
apply the same updates: their delta logs, manifests and generations must
be equal, and a session of each must give the same answers, loads,
iterations and every ``LoadStats`` field (``delta_overlays`` included)
on OPAT and TraditionalMP at host capacities 1 and 2.  MapReduceMP needs
four devices in the reference, so it is held to the oracle and to a
fresh save.  A crash sweep through ``repro_torch.storage.format.fault_hook``
covers every durable write of mutate → compact → mutate → compact.
"""
import json
import math
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import match_disjunctive as ref_match
from repro.data.generators import subgen_queries as ref_subgen_queries
from repro.storage import HostShardCache as RefHostShardCache
from repro.storage.deltas import open_mutable as ref_open_mutable

import repro_torch.core as tc
from repro_torch.core.oracle import match_disjunctive
from repro_torch.data.generators import subgen_queries
from repro_torch.storage import DiskCatalog, HostShardCache, StorageFormatError
from repro_torch.storage import format as storage_format
from repro_torch.storage.deltas import DELETED_LABEL, open_mutable

CAP = 2048
HOST_PARTS = (1, 2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes at once).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges_of(g, x):
    """(u, v, label, directed) of every edge at vertex ``x``."""
    src, dst = np.asarray(g.edge_src), np.asarray(g.edge_dst)
    lab, dr = np.asarray(g.edge_label), np.asarray(g.edge_directed)
    return [(int(src[i]), int(dst[i]), g.edge_vocab.str_of(int(lab[i])), bool(dr[i]))
            for i in np.flatnonzero((src == x) | (dst == x))]


def make_ops(g, pg, q4_answers):
    """Two batches of updates over graph ``g``.

    ``a``: clone a vertex bound in Q4's first answer (label, value and
    every edge, onto the partition that owns the original), so the clone
    answers Q4 wherever the original does; delete two edges and one
    vertex no answer of Q4 binds.  ``b``: add edges at the highest-degree
    vertex until its degree is the ELL width plus two, so the next
    generation's width grows past the manifest's; and one more vertex."""
    V = int(g.n_nodes)
    x = int(q4_answers[0][q4_answers[0] >= 0][-1])
    a = [{"op": "vertex_add", "label": g.node_vocab.str_of(int(g.node_label[x])),
          "value": float(g.node_value[x]), "pid": int(pg.assignment[x])}]
    for u, v, lab, d in _edges_of(g, x):
        a.append({"op": "edge_add", "u": V if u == x else u, "v": V if v == x else v,
                  "label": lab, "directed": d})
    bound = {int(v) for v in np.asarray(q4_answers).ravel() if v >= 0}
    free = [v for v in range(V) if v not in bound]
    for u, v, lab, _ in _edges_of(g, free[0])[:2]:
        a.append({"op": "edge_del", "u": u, "v": v, "label": lab})
    a.append({"op": "vertex_del", "u": free[-1]})
    deg = g.degree_view()
    hub = int(np.argmax(deg))
    W = int(pg.ell_width)
    others = [v for v in range(V) if v != hub and v not in (free[-1],)]
    lab0 = g.edge_vocab.str_of(0)
    b = [{"op": "edge_add", "u": hub, "v": int(others[i]), "label": lab0}
         for i in range(W - int(deg[hub]) + 2)]
    b.append({"op": "vertex_add", "label": g.node_vocab.str_of(int(g.node_label[hub])),
              "value": float(g.node_value[hub])})
    return a, b


@pytest.fixture(scope="module")
def setup(small_graph, small_pg, tmp_path_factory):
    """The base graph directory (saved by the reference), the queries of
    both packages, the update batches and the opened geometry."""
    g, pg = small_graph, small_pg
    base = str(tmp_path_factory.mktemp("mutation") / "base")
    RefSession(pg=pg).save(base)
    dqs = ref_subgen_queries(g)
    q4 = ref_match(g, dqs[0], q_pad=8)
    assert q4.shape[0] > 0
    ops_a, ops_b = make_ops(g, pg, q4)
    port = tc.GraphSession.open(base, device="cpu")
    return dict(g=g, pg=pg, base=base, dqs=dqs, tdqs=subgen_queries(port.graph),
                ops_a=ops_a, ops_b=ops_b, V=int(g.n_nodes), W=int(pg.ell_width))


def _copy(setup, tmp_path, name):
    path = str(tmp_path / name)
    shutil.copytree(setup["base"], path)
    return path


def _dir_state(path):
    """Every file of a graph directory: name -> bytes (manifest and logs
    in full; shards and graph files are content-addressed by name)."""
    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".json") or f.endswith(".log"):
            with open(os.path.join(path, f), "rb") as fh:
                out[f] = fh.read()
        else:
            out[f] = None
    return out


def test_same_updates_write_the_same_directory(setup, tmp_path):
    """The same updates and compactions through both packages' writers:
    delta logs, manifests, file names and generations equal after every
    step."""
    ref_dir, port_dir = _copy(setup, tmp_path, "ref"), _copy(setup, tmp_path, "port")
    ref, port = ref_open_mutable(ref_dir), open_mutable(port_dir)
    steps = [("ops", setup["ops_a"]), ("compact", 1), ("ops", setup["ops_b"]),
             ("compact", None)]
    for kind, arg in steps:
        if kind == "ops":
            got = [port.apply_op(d) for d in arg]
            want = [ref.apply_op(d) for d in arg]
            assert [r.to_json() for r in got] == [r.to_json() for r in want]
            assert port.pending_counts().tolist() == ref.pending_counts().tolist()
        elif arg is None:
            assert port.compact_all() == ref.compact_all()
        else:
            assert port.compact(arg) == ref.compact(arg)
        assert port.generation == ref.generation and port.max_seq() == ref.max_seq()
        assert _dir_state(port_dir) == _dir_state(ref_dir), (kind, arg)
        pv, rv = port.snapshot(), ref.snapshot()
        assert pv.bundle_token(0) == rv.bundle_token(0)
        assert pv.stale_pids == rv.stale_pids
        pv.release(), rv.release()
    assert port.compactions == ref.compactions == 5
    with open(os.path.join(port_dir, "manifest.json")) as f:
        assert json.load(f)["ell_width"] > setup["W"]


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
    """Both packages' read-aheads join their worker before returning, so
    neither side's counters follow thread timing (as in
    tests/test_torch_storage.py)."""
    monkeypatch.setattr(RefHostShardCache, "read_ahead",
                        _joined(RefHostShardCache.read_ahead, _ref_workers))
    monkeypatch.setattr(HostShardCache, "read_ahead",
                        _joined(HostShardCache.read_ahead, lambda t: list(t._workers)))


def _same_result(a, b, ctx):
    np.testing.assert_array_equal(a.answers, b.answers, err_msg=str(ctx))
    assert a.load_stats.to_dict() == b.load_stats.to_dict(), ctx
    assert a.generation == b.generation, ctx
    assert [r.stats.loads for r in a.reports] == [r.stats.loads for r in b.reports], ctx
    assert [r.stats.iterations for r in a.reports] == \
        [r.stats.iterations for r in b.reports], ctx
    assert [r.stats.generation for r in a.reports] == [a.generation] * len(a.reports)


@pytest.mark.parametrize("host_parts", HOST_PARTS)
@pytest.mark.parametrize("engine", ["opat", "traditional"])
def test_mutated_session_matches_reference(setup, tmp_path, read_aheads_land_at_once,
                                           engine, host_parts):
    """Opened sessions of both packages through stale (overlay),
    compacted and grown generations: every submit and submit_many equal
    (answers, loads, iterations, every LoadStats field, generation), every
    answer the oracle's over the session's overlay graph, an answer binds
    the vertex added in the session, the ELL width grows, and the
    profiles end equal."""
    kw = dict(engine=engine, seed=1, processors=2, cache_parts=1,
              host_cache_parts=host_parts)
    ref = RefSession.open(_copy(setup, tmp_path, "ref"), config=RefConfig(cap=CAP), **kw)
    port = tc.GraphSession.open(_copy(setup, tmp_path, "port"),
                                config=tc.EngineConfig(cap=CAP), device="cpu", **kw)
    assert port.mutable and port.generation == 0 and port.current_view is not None
    dqs, tdqs, V = setup["dqs"], setup["tdqs"], setup["V"]
    overlays = 0

    def serve(step):
        nonlocal overlays
        for dq, tdq in zip(dqs, tdqs):
            a, b = port.submit(tdq), ref.submit(dq)
            _same_result(a, b, (step, dq.name))
            np.testing.assert_array_equal(
                a.answers, match_disjunctive(port.graph, tdq, q_pad=8))
            overlays += a.load_stats.delta_overlays
        return a

    port.mutate(setup["ops_a"]), ref.mutate(setup["ops_a"])
    assert port.generation == ref.generation == 0
    assert port.current_view.stale_pids == ref.current_view.stale_pids != set()
    serve("stale")
    q4 = port.submit(tdqs[0]).answers
    ref.submit(dqs[0])
    assert (q4 >= V).any(), "no answer binds the vertex added in the session"
    assert port.compact(1) == ref.compact(1) == 1
    serve("compacted")
    port.mutate(setup["ops_b"]), ref.mutate(setup["ops_b"])
    assert port.pg.ell_width == ref.pg.ell_width > setup["W"]
    assert port.pg.node_pad == ref.pg.node_pad
    got = port.submit_many(tdqs, max_answers=[None, 2, None])
    want = ref.submit_many(dqs, max_answers=[None, 2, None])
    assert (got.loads, got.batch_sizes) == (want.loads, want.batch_sizes)
    assert got.load_stats.to_dict() == want.load_stats.to_dict()
    for a, b in zip(got.results, want.results):
        _same_result(a, b, ("many", a.name))
    overlays += got.load_stats.delta_overlays
    assert port.compact_all() == ref.compact_all()
    serve("compact_all")
    assert overlays > 0
    assert port.load_stats.to_dict() == ref.load_stats.to_dict()
    assert port.workload_profile() == ref.workload_profile()


def test_mapreduce_final_generation_matches_oracle_and_fresh_save(setup, tmp_path):
    """MapReduceMP on a stale view and on the final generation: answers
    equal the oracle over the overlay graph and a fresh save of it."""
    sess = tc.GraphSession.open(_copy(setup, tmp_path, "mr"), engine="mapreduce",
                                config=tc.EngineConfig(cap=CAP), device="cpu",
                                cache_parts=1, host_cache_parts=2)
    tdqs = setup["tdqs"]
    sess.mutate(setup["ops_a"])
    for tdq in tdqs:
        r = sess.submit(tdq)
        np.testing.assert_array_equal(r.answers, match_disjunctive(sess.graph, tdq, q_pad=8))
    assert sess.load_stats.delta_overlays > 0
    assert (sess.submit(tdqs[0]).answers >= setup["V"]).any()
    sess.compact(0)
    sess.mutate(setup["ops_b"])
    sess.compact_all()
    fresh_dir = str(tmp_path / "fresh")
    tc.GraphSession(pg=tc.build_partitions(sess.graph, sess.pg.assignment, 4,
                                           scheme="kway_shem"),
                    device="cpu").save(fresh_dir)
    fresh = tc.GraphSession.open(fresh_dir, engine="mapreduce",
                                 config=tc.EngineConfig(cap=CAP), device="cpu")
    for tdq in tdqs:
        r = sess.submit(tdq)
        assert r.generation == sess.generation > 0
        np.testing.assert_array_equal(r.answers, match_disjunctive(sess.graph, tdq, q_pad=8))
        np.testing.assert_array_equal(r.answers, fresh.submit(tdq).answers)
    assert sess.store.owner.shape[0] == sess.graph.n_nodes == setup["V"] + 2


@pytest.mark.parametrize("layout", [[[0], [1], [2], [3]], [[0], [1, 2, 3]]])
def test_mapreduce_on_a_mesh_follows_the_view(setup, tmp_path, layout):
    """MapReduceMP on a multi-shard mesh of an opened, mutated session:
    the owner table and the stacks of every shard follow the view (a stale
    view's overlay, then the widened final generation), so each run equals
    the default one-shard session's on the same updates (answers,
    iterations, loads) and the oracle over the overlay graph."""
    mesh = tc.PartMesh(tuple(("cpu", p) for p in layout))
    one, many = (tc.GraphSession.open(_copy(setup, tmp_path, name), engine="mapreduce",
                                      config=tc.EngineConfig(cap=CAP), device="cpu",
                                      host_cache_parts=1, mesh=m)
                 for name, m in (("one", None), ("many", mesh)))
    assert many.engine.mesh == mesh and one.engine.mesh.lanes == (4,)
    for ops in (setup["ops_a"], setup["ops_b"]):
        for sess in (one, many):
            sess.mutate(ops)
        for tdq in setup["tdqs"]:
            a, b = many.submit(tdq), one.submit(tdq)
            np.testing.assert_array_equal(a.answers,
                                          match_disjunctive(many.graph, tdq, q_pad=8))
            np.testing.assert_array_equal(a.answers, b.answers)
            assert a.reports[0].stats.iterations == b.reports[0].stats.iterations
            assert a.load_stats.to_dict() == b.load_stats.to_dict()
    for sess in (one, many):
        sess.compact_all()
    for tdq in setup["tdqs"]:
        a = many.submit(tdq)
        assert a.generation == many.generation > 0
        np.testing.assert_array_equal(a.answers, one.submit(tdq).answers)
    assert many.store.owner_on("cpu").shape[0] == many.graph.n_nodes == setup["V"] + 2


@pytest.mark.parametrize("engine", ["opat", "traditional"])
def test_pinned_generation_survives_compaction_and_gc(setup, tmp_path, engine):
    """A scheduler pinned to generation G keeps answering from G after an
    update and compact_all publish G+1 (its queries, served after the
    publish and one admitted after its first round, equal G's oracle); two generations of one partition are
    device-resident at once; G's files survive GC until close()."""
    work = _copy(setup, tmp_path, "pin")
    sess = tc.GraphSession.open(work, engine=engine, seed=1,
                                config=tc.EngineConfig(cap=CAP), device="cpu")
    tdqs = setup["tdqs"]
    gen0 = sess.generation
    sched = sess.scheduler()
    for dq in tdqs:
        sched.admit(dq)
    pinned_graph, pinned_files = sched.view.graph, sched.view.files()
    ref0 = match_disjunctive(pinned_graph, tdqs[0], q_pad=8)
    sess.del_vertex(int(ref0[ref0 >= 0].flat[0]))
    new_gen = sess.compact_all()
    assert new_gen > gen0 and sess.generation == new_gen
    assert not np.array_equal(match_disjunctive(sess.graph, tdqs[0], q_pad=8), ref0)
    for f in pinned_files:
        assert os.path.exists(os.path.join(work, f)), f
    # serving starts after the publish, and a query admitted between two
    # runs joins the pinned generation too
    partial = sched.run(max_rounds=1)
    sched.admit(tdqs[0])
    results = partial.results + sched.run().results
    assert len(results) == len(tdqs) + 1
    for res in results:
        assert res.generation == gen0
        dq = next(q for q in tdqs if q.name == res.name)
        np.testing.assert_array_equal(res.answers,
                                      match_disjunctive(pinned_graph, dq, q_pad=8))
    res = sess.submit(tdqs[0])
    assert res.generation == new_gen
    np.testing.assert_array_equal(res.answers, match_disjunctive(sess.graph, tdqs[0], q_pad=8))
    if engine == "opat":
        pid = int(res.reports[0].stats.loads[0])
        assert len(sess.store._cache_keys_for(pid)) == 2   # G and G+1 resident
    live = sess._mdir.catalog
    superseded = pinned_files - ({p["shard"] for p in live.manifest["partitions"]}
                                 | {live.graph_file})
    assert superseded
    sess._mdir.gc()
    assert all(os.path.exists(os.path.join(work, f)) for f in superseded)
    sched.close()
    sched.close()                               # idempotent
    sess._mdir.gc()
    assert not any(os.path.exists(os.path.join(work, f)) for f in superseded)
    with pytest.raises(RuntimeError, match="close"):
        sched.admit(tdqs[0])


def test_fold_repartition_matches_reference(setup, tmp_path, read_aheads_land_at_once):
    """fold(repartition=True) after served and updated traffic: the same
    layout, directory and generation as the reference's, then the same
    answers, loads and counters; a scheduler of the old binding refuses
    to serve."""
    kw = dict(engine="opat", seed=1, cache_parts=1)
    ref_dir, port_dir = _copy(setup, tmp_path, "ref"), _copy(setup, tmp_path, "port")
    ref = RefSession.open(ref_dir, config=RefConfig(cap=CAP), **kw)
    port = tc.GraphSession.open(port_dir, config=tc.EngineConfig(cap=CAP),
                                device="cpu", **kw)
    dqs, tdqs = setup["dqs"], setup["tdqs"]
    for dq, tdq in zip(dqs, tdqs):
        port.submit(tdq), ref.submit(dq)
    port.mutate(setup["ops_a"]), ref.mutate(setup["ops_a"])
    old = port.scheduler()
    got, want = port.fold(repartition=True, seed=0), ref.fold(repartition=True, seed=0)
    assert got == want
    assert port.repartitions == ref.repartitions == 1
    assert port.scheme == "waw" and port.generation == ref.generation == 1
    np.testing.assert_array_equal(port.pg.assignment, ref.pg.assignment)
    assert _dir_state(port_dir) == _dir_state(ref_dir)
    for dq, tdq in zip(dqs, tdqs):
        _same_result(port.submit(tdq), ref.submit(dq), ("fold", dq.name))
    with pytest.raises(RuntimeError, match="rebound"):
        old.run()
    assert port.fold() == ref.fold()
    assert port.workload_profile() == ref.workload_profile()


def test_repartition_releases_the_view(setup, tmp_path):
    """repartition() moves a mutable session in RAM: the view's pin is
    released and further updates raise; in-RAM sessions refuse updates."""
    sess = tc.GraphSession.open(_copy(setup, tmp_path, "rp"), device="cpu",
                                config=tc.EngineConfig(cap=CAP))
    view = sess.current_view
    sess.submit(setup["tdqs"][0])
    sess.repartition(seed=0)
    assert not sess.mutable and sess.generation is None
    assert id(view) not in view.mdir._pins
    with pytest.raises(RuntimeError, match="disk-backed"):
        sess.add_edge(0, 1, "x")
    prof = sess.workload_profile()
    assert "generation" not in prof and "delta_count" not in prof["partitions"][0]


# ---------------------------------------------------------------------------
# crashes and guardrails
# ---------------------------------------------------------------------------

class _Crash(BaseException):
    """Raised by the fault hook; not an Exception, so nothing swallows it."""


def canon(g):
    """A graph as sorted (gid, label, value) nodes and (u, v, label,
    directed) edges: gids are stable across the delta path."""
    nodes = tuple((i, g.node_vocab.str_of(int(lab)), None if math.isnan(val) else float(val))
                  for i, (lab, val) in enumerate(zip(np.asarray(g.node_label),
                                                     np.asarray(g.node_value))))
    edges = tuple(sorted((int(u), int(v), g.edge_vocab.str_of(int(lab)), bool(d))
                         for u, v, lab, d in zip(np.asarray(g.edge_src),
                                                 np.asarray(g.edge_dst),
                                                 np.asarray(g.edge_label),
                                                 np.asarray(g.edge_directed))))
    return nodes, edges


def _scenario(path, ops_a, ops_b, states=None):
    """mutate → compact(1) → mutate → compact_all through the port's
    writer; ``states`` collects the canon after each durable record."""
    mdir = open_mutable(path)
    for ops, compact in ((ops_a, lambda: mdir.compact(1)), (ops_b, mdir.compact_all)):
        for d in ops:
            mdir.apply_op(d)
            if states is not None:
                states.append(canon(mdir.snapshot().graph))
        compact()


def test_crash_sweep_previous_generation_stays_servable(setup, tmp_path):
    """A crash before any durable step of mutate → compact → mutate →
    compact_all: the directory reopens, its published generation reads
    back checksum-clean, the recovered graph is one of the durable
    prefixes, a follow-up compact_all keeps it, and (every fourth point
    and the last) an opened session serves Q4 as the oracle does."""
    ops_a, ops_b = setup["ops_a"][:3], setup["ops_b"][:2]
    seen = []
    states = [canon(open_mutable(setup["base"]).snapshot().graph)]
    storage_format.fault_hook = lambda step, path: seen.append((step, path))
    try:
        _scenario(_copy(setup, tmp_path, "count"), ops_a, ops_b, states)
    finally:
        storage_format.fault_hook = None
    assert {s for s, _ in seen} == {"write", "rename", "unlink"}
    tdq = setup["tdqs"][0]
    for n in range(len(seen)):
        work = _copy(setup, tmp_path, f"crash-{n}")
        count = [0]

        def hook(step, path):
            count[0] += 1
            if count[0] - 1 == n:
                raise _Crash(step, path)
        storage_format.fault_hook = hook
        try:
            with pytest.raises(_Crash):
                _scenario(work, ops_a, ops_b)
        finally:
            storage_format.fault_hook = None
        cat = DiskCatalog(work)
        for pid in range(cat.k):
            cat.read_part(pid)
        got = canon(open_mutable(work).snapshot().graph)
        assert got in states, (n, seen[n])
        if n % 4 == 0 or n == len(seen) - 1:
            sess = tc.GraphSession.open(work, device="cpu", config=tc.EngineConfig(cap=CAP))
            np.testing.assert_array_equal(sess.submit(tdq).answers,
                                          match_disjunctive(sess.graph, tdq, q_pad=8))
        mdir = open_mutable(work)
        mdir.compact_all()
        assert canon(open_mutable(work).snapshot().graph) == got, n
        shutil.rmtree(work)


@pytest.mark.parametrize("case", ["tombstone", "bad_gid", "unknown_op"])
def test_mutation_guardrails_match_reference(setup, tmp_path, case):
    """An edge to a tombstone, an endpoint out of range and an unknown op
    are refused with the reference's errors, and nothing is written."""
    ref, port = (f(_copy(setup, tmp_path, name))
                 for f, name in ((ref_open_mutable, "ref"), (open_mutable, "port")))
    for mdir in (ref, port):
        mdir.del_vertex(3)
    op = {"tombstone": {"op": "edge_add", "u": 3, "v": 5, "label": "x"},
          "bad_gid": {"op": "edge_add", "u": 0, "v": 10_000, "label": "x"},
          "unknown_op": {"op": "nope"}}[case]
    with pytest.raises(ValueError) as want:
        ref.apply_op(op)
    with pytest.raises(ValueError) as got:
        port.apply_op(op)
    assert str(got.value) == str(want.value)
    assert port.max_seq() == ref.max_seq() == 1
    assert port.snapshot().graph.node_vocab.str_of(
        int(port.snapshot().graph.node_label[3])) == DELETED_LABEL
    with pytest.raises(StorageFormatError, match="unknown delta op"):
        from repro_torch.storage.deltas import DeltaRecord
        DeltaRecord.from_dict({"seq": 1, "op": "nope"})
