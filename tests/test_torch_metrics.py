"""The PyTorch port's metrics registry (``repro_torch.obs.metrics``) and
its Prometheus export (``repro_torch.obs.export``) against the JAX
package's, on the CPU.

The same registry contents must export byte-equal text.  Then both
packages serve the same graph, partitions and queries with profiling on,
and ``ingest_session`` (plus ``ingest_schedule`` for a ``submit_many``
report) must give the same metric names, label sets and values, apart
from the process's peak RSS: in RAM on all three engines (MapReduceMP at
k=1, since the reference needs a device per partition), out of core
through a one-partition host tier (the disk-byte counter), on a mutable
directory after updates and a compaction (generation, pending and
compaction gauges), and after a front-end run under instant replay (the
SLO counters, shed reasons and burn rates).
"""
import math
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as ref_obs
from repro import serving as ref_serving
from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import LoadStats as RefLoadStats
from repro.core import build_partitions as ref_build_partitions
from repro.data.generators import subgen_queries as ref_subgen_queries
from repro.storage import HostShardCache as RefHostShardCache

import repro_torch.core as tc
from repro_torch import obs, serving
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.data.generators import subgen_queries
from repro_torch.storage import HostShardCache

CAP = 1024
RSS = "repro_session_peak_rss_bytes"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes at once).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the registry and its text
# ---------------------------------------------------------------------------

def _fill(m, case, LoadStats):
    """A registry of package ``m`` (either package's ``obs``) holding one
    case's contents."""
    reg = m.MetricsRegistry()
    if case in ("counters", "mixed"):
        reg.counter("repro_a_total", help="a counter").inc(3)
        reg.counter("repro_a_total", help="a counter").inc(0.5)
        reg.counter("repro_b_total").set_total(7)
    if case in ("labelled", "mixed"):
        reg.counter("repro_shed_total", help="sheds", reason="deadline").set_total(2)
        reg.counter("repro_shed_total", help="sheds", reason="backlog").set_total(5)
        reg.gauge("repro_burn", help="burn", slo_class="batch", zone="b").set(0.125)
        reg.gauge("repro_burn", help="burn", slo_class="interactive").set(58.33)
        reg.gauge("repro_level").inc(-1.5)
    if case in ("histograms", "mixed"):
        h = reg.histogram("repro_h", help="occupancy", buckets=(4, 1, 2))
        for v in (0.5, 1, 1, 3, 9, 64):
            h.observe(v)
        reg.histogram("repro_h", help="occupancy", buckets=(1, 2), lane="x").observe(0.25)
        reg.histogram("repro_lat_seconds", help="latency").observe(0.007)
    if case == "ingested":
        m.ingest_load_stats(reg, LoadStats(hits=4, misses=3, bytes_cold=123,
                                           disk_reads=2, delta_overlays=1))
        m.ingest_schedule(reg, [0, 1, 1, 3], [1, 2, 5, 9, 70])
        m.ingest_frontend(reg, {"arrived": 9, "shed": 2, "served": 7},
                          {"deadline-unreachable": 2})
    return reg


@pytest.mark.parametrize("case", ["empty", "counters", "labelled", "histograms",
                                  "mixed", "ingested"])
def test_prometheus_text_byte_equal_to_reference(case, tmp_path):
    want = _fill(ref_obs, case, RefLoadStats)
    got = _fill(obs, case, tc.LoadStats)
    assert obs.to_prometheus_text(got) == ref_obs.to_prometheus_text(want)
    assert got.snapshot() == want.snapshot()
    obs.write_prometheus(got, str(tmp_path / "m.prom"))
    assert (tmp_path / "m.prom").read_text() == ref_obs.to_prometheus_text(want)


# ---------------------------------------------------------------------------
# ingest_session on the same run
# ---------------------------------------------------------------------------

def _port_graph(g):
    def vocab(v):
        return [v.str_of(i) for i in range(len(v))]
    return graph_from_arrays(node_label=g.node_label, node_value=g.node_value,
                             edge_src=g.edge_src, edge_dst=g.edge_dst,
                             edge_label=g.edge_label,
                             edge_directed=g.edge_directed,
                             node_vocab=vocab(g.node_vocab),
                             edge_vocab=vocab(g.edge_vocab))


@pytest.fixture(scope="module")
def both(small_graph, small_pg, tmp_path_factory):
    """(reference graph, reference pg, port graph, port pg, reference
    queries, port queries, a graph directory the reference saved)."""
    g, pg = small_graph, small_pg
    tg = _port_graph(g)
    tpg = partitioned_graph_from_arrays(tg, pg.assignment, pg.k, pg.scheme)
    base = str(tmp_path_factory.mktemp("metrics") / "base")
    RefSession(pg=pg).save(base)
    return g, pg, tg, tpg, ref_subgen_queries(g), subgen_queries(tg), base


def _prom(m, sess, report=None):
    """Package ``m``'s Prometheus text of a session (and a submit_many
    report), without the process's peak RSS."""
    reg = m.MetricsRegistry()
    m.ingest_session(reg, sess)
    if report is not None:
        m.ingest_schedule(reg, report.loads, report.batch_sizes)
    return [ln for ln in m.to_prometheus_text(reg).splitlines()
            if not ln.startswith(RSS)]


def _serve(sess, queries):
    """Each query, Q4 again under a budget of 5, then all of them through
    ``submit_many``; returns the schedule report."""
    for q in queries:
        sess.submit(q)
    sess.submit(queries[0], max_answers=5)
    return sess.submit_many(queries)


def _assert_same(ref, port, dqs, tdqs, must_have=()):
    want = _prom(ref_obs, ref, _serve(ref, dqs))
    got = _prom(obs, port, _serve(port, tdqs))
    for name in ("repro_session_peak_device_bytes", "repro_store_cold_loads_total",
                 "repro_scheduler_batch_occupancy_bucket", *must_have):
        assert any(ln.startswith(name) for ln in got), name
    assert got == want


@pytest.mark.parametrize("engine", ["opat", "traditional", "mapreduce"])
def test_ingest_session_matches_reference_in_ram(both, engine):
    g, pg, tg, tpg, dqs, tdqs, _ = both
    if engine == "mapreduce":
        pg = ref_build_partitions(g, np.zeros(g.n_nodes, dtype=np.int32), 1,
                                  scheme="kway_shem")
        tpg = partitioned_graph_from_arrays(tg, pg.assignment, 1, pg.scheme)
    ref = RefSession(pg=pg, engine=engine, seed=1, processors=2,
                     config=RefConfig(cap=CAP), tracer=ref_obs.Tracer())
    port = tc.GraphSession(pg=tpg, engine=engine, seed=1, processors=2,
                           config=tc.EngineConfig(cap=CAP), device="cpu",
                           tracer=obs.Tracer())
    _assert_same(ref, port, dqs, tdqs)


def _joined(read_ahead, workers):
    """A read-ahead that lands before it returns, so the host tier's
    counters follow no thread timing in either package."""
    def issue_and_join(self, *args, **kwargs):
        issued = read_ahead(self, *args, **kwargs)
        for t in workers(self):
            t.join(timeout=60)
        return issued
    return issue_and_join


def _ref_workers(tier):
    with tier._lock:
        return list(tier._pending.values())


def _opened(both, tmp_path, monkeypatch, engine, host_parts):
    """Both packages' sessions over copies of the saved directory."""
    *_, base = both
    monkeypatch.setattr(RefHostShardCache, "read_ahead",
                        _joined(RefHostShardCache.read_ahead, _ref_workers))
    monkeypatch.setattr(HostShardCache, "read_ahead",
                        _joined(HostShardCache.read_ahead, lambda t: list(t._workers)))
    dirs = [str(tmp_path / name) for name in ("ref", "port")]
    for d in dirs:
        shutil.copytree(base, d)
    ref = RefSession.open(dirs[0], engine=engine, seed=1, processors=2,
                          config=RefConfig(cap=CAP), host_cache_parts=host_parts,
                          tracer=ref_obs.Tracer())
    port = tc.GraphSession.open(dirs[1], engine=engine, seed=1, processors=2,
                                config=tc.EngineConfig(cap=CAP),
                                host_cache_parts=host_parts, device="cpu",
                                tracer=obs.Tracer())
    return ref, port


@pytest.mark.parametrize("engine", ["opat", "traditional"])
def test_ingest_session_matches_reference_out_of_core(both, tmp_path, monkeypatch,
                                                      engine):
    """Through a one-partition host tier: the disk tier's counters and the
    disk catalog's byte counter too."""
    *_, dqs, tdqs, _ = both
    ref, port = _opened(both, tmp_path, monkeypatch, engine, host_parts=1)
    _assert_same(ref, port, dqs, tdqs,
                 must_have=("repro_store_disk_bytes_total", "repro_deltas_generation"))


def test_ingest_session_matches_reference_mutable(both, tmp_path, monkeypatch):
    """After updates, queries on the stale view and one compaction: the
    generation, pending and compaction gauges and the overlay counter."""
    g, *_, dqs, tdqs, _ = both
    ref, port = _opened(both, tmp_path, monkeypatch, "opat", host_parts=2)
    lab = g.edge_vocab.str_of(0)
    V = int(g.n_nodes)
    updates = ([{"op": "edge_add", "u": u, "v": (u * 7 + 3) % V, "label": lab}
                for u in (1, 17, 40, 99)]
               + [{"op": "vertex_add", "label": g.node_vocab.str_of(0), "value": 0.5},
                  {"op": "edge_add", "u": V, "v": 5, "label": lab}])
    for sess, queries in ((ref, dqs), (port, tdqs)):
        sess.mutate(updates)
        sess.submit(queries[1])
        sess.compact(0)
        sess.add_edge(3, 11, lab)
    _assert_same(ref, port, dqs, tdqs,
                 must_have=("repro_deltas_pending", "repro_deltas_compactions_total 1",
                            "repro_deltas_generation"))
    assert ref.generation == port.generation


def _frontend(pkg, sess):
    """Instant replay with a fresh cost model at 2 s a unit: the batch
    class's 4 ms deadline sheds all of it (it cannot be degraded), and the
    others are served within their deadlines whatever the wall clock
    says."""
    cm = pkg.CostModel(sess.pg, default_rate_s=2.0)
    classes = [pkg.SLOClass("interactive", deadline_s=600.0, priority=0),
               pkg.SLOClass("batch", deadline_s=0.004, priority=1,
                            sheddable=True),
               pkg.SLOClass("exhaustive", deadline_s=math.inf, priority=2,
                            deferrable=True, sheddable=True)]
    fe = sess.frontend(cost_model=cm, slo_classes=classes, shed_policy="deadline")
    reqs = [pkg.Request(q, slo_class=("interactive", "batch", "exhaustive")[i % 3],
                        arrival_s=0.001 * i)
            for i, q in enumerate(sess_queries(pkg, sess) * 2)]
    return fe.serve(reqs)


def sess_queries(pkg, sess):
    return (ref_subgen_queries(sess.graph) if pkg is ref_serving
            else subgen_queries(sess.graph))


def test_ingest_session_matches_reference_after_frontend(both):
    """After a front-end run: the SLO counters, shed reasons and burn
    rates (every served deadline met, so the rates are the wall clock's
    in neither package)."""
    g, pg, tg, tpg, *_ = both
    ref = RefSession(pg=pg, seed=1, config=RefConfig(cap=CAP), tracer=ref_obs.Tracer())
    port = tc.GraphSession(pg=tpg, seed=1, config=tc.EngineConfig(cap=CAP),
                           device="cpu", tracer=obs.Tracer())
    want, got = _frontend(ref_serving, ref), _frontend(serving, port)
    assert got.counters == want.counters and got.counters["shed"]
    assert all(o.deadline_met is not False for o in got.served)   # None: no deadline
    got_text, want_text = _prom(obs, port), _prom(ref_obs, ref)
    for name in ("repro_frontend_shed_reason_total{", "repro_frontend_slo_burn_rate{",
                 "repro_frontend_arrived_total"):
        assert any(ln.startswith(name) for ln in got_text), name
    assert got_text == want_text
