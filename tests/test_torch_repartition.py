"""The PyTorch port's workload-aware repartitioning
(``repro_torch.core.repartition`` and ``GraphSession.repartition``)
against the JAX package's, on the CPU.

The same profile and seed must give the same edge weights, the same new
vertex assignment and the same summary dict, and after the rebind the
same answers, loads and iterations, on all three engines.  MapReduceMP at
k = 4 needs four devices in the reference, so its side runs once in a
subprocess with four forced host devices.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import build_partitions as ref_build_partitions
from repro.core import match_disjunctive, partition_graph as ref_partition_graph
from repro.core.repartition import RepartitionConfig as RefRepartitionConfig
from repro.core.repartition import repartition_assignment as ref_assignment
from repro.core.repartition import reweight_edges as ref_reweight_edges
from repro.data.generators import subgen_like_graph as ref_subgen_graph
from repro.data.generators import subgen_queries as ref_subgen_queries

import repro_torch.core as tc
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.data.generators import subgen_queries
from repro_torch.storage import DiskCatalog

CAP = 4096
SEED = 5

MR_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.core import (EngineConfig, GraphSession, build_partitions,
                            partition_graph)
    from repro.data.generators import subgen_like_graph, subgen_queries

    CAP, SEED = {consts}
    g = subgen_like_graph(n_nodes=250, n_edges=700, n_embed=10, seed=3)
    pg = build_partitions(g, partition_graph(g, 4, "kway_shem"), 4,
                          scheme="kway_shem")
    sess = GraphSession(pg=pg, engine="mapreduce", seed=1,
                        config=EngineConfig(cap=CAP))
    dqs = subgen_queries(g)

    def serve():
        out = []
        for dq in dqs:
            r = sess.submit(dq)
            out.append({{"answers": r.answers.tolist(),
                        "iterations": r.reports[0].stats.iterations,
                        "loads": r.reports[0].stats.loads,
                        "load_stats": r.load_stats.to_dict()}})
        return out

    before = serve()
    profile = sess.workload_profile()
    info = sess.repartition(seed=SEED)
    out = {{"before": before, "profile": profile, "info": info,
           "assignment": sess.pg.assignment.astype(int).tolist(),
           "after": serve(), "profile_after": sess.workload_profile()}}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
""").format(consts=repr((CAP, SEED)))


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
def both():
    """(reference graph, reference pg, port graph, port pg, reference
    queries, port queries): the graph of the MapReduceMP subprocess."""
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
    return g, pg, tg, tpg, ref_subgen_queries(g), subgen_queries(tg)


def _sessions(both, engine):
    g, pg, tg, tpg, dqs, tdqs = both
    kw = dict(engine=engine, seed=1, processors=2, cache_parts=2)
    return (RefSession(pg=pg, config=RefConfig(cap=CAP), **kw),
            tc.GraphSession(pg=tpg, config=tc.EngineConfig(cap=CAP), device="cpu", **kw))


def _serve_equal(ref, port, dqs, tdqs):
    for dq, tdq in zip(dqs, tdqs):
        a, b = port.submit(tdq), ref.submit(dq)
        np.testing.assert_array_equal(a.answers, b.answers, err_msg=dq.name)
        assert [r.stats.loads for r in a.reports] == [r.stats.loads for r in b.reports]
        assert [r.stats.iterations for r in a.reports] == \
            [r.stats.iterations for r in b.reports], dq.name
        assert a.load_stats.to_dict() == b.load_stats.to_dict(), dq.name


@pytest.fixture(scope="module")
def opat_profile(both):
    """The workload profile of an OPAT session that served the queries."""
    ref, port = _sessions(both, "opat")
    _serve_equal(ref, port, both[4], both[5])
    assert port.workload_profile() == ref.workload_profile()
    return port.workload_profile()


def _pair_counts_only(profile):
    prof = json.loads(json.dumps(profile))
    del prof["answer_spans"]["vertex_span_counts"]
    return prof


@pytest.mark.parametrize("variant", ["default", "pair_counts_only", "no_cohesion",
                                     "no_load_counters"])
def test_assignment_and_weights_match_reference(both, opat_profile, tmp_path, variant):
    """reweight_edges and repartition_assignment equal the reference's for
    the same profile, config and seed: the co-traversal pull from vertex
    span counts or (older profiles) pair counts, the split pressure, and a
    MapReduceMP-style profile with no load counters; a profile read back
    from its JSON file gives the same assignment."""
    g, pg, tg = both[:3]
    prof, cfg, rcfg = opat_profile, tc.RepartitionConfig(), RefRepartitionConfig()
    if variant == "pair_counts_only":
        prof = _pair_counts_only(prof)
    elif variant == "no_cohesion":
        cfg = tc.RepartitionConfig(boundary_gain=4, cohesion_gain=0)
        rcfg = RefRepartitionConfig(boundary_gain=4, cohesion_gain=0)
    elif variant == "no_load_counters":
        prof = dict(prof, partition_counters_observed=False)
    assign = np.asarray(prof["assignment"], dtype=np.int32)
    w = tc.reweight_edges(tg, assign, prof, cfg)
    np.testing.assert_array_equal(w, ref_reweight_edges(g, assign, prof, rcfg))
    assert w.max() > 1
    want = ref_assignment(g, prof, seed=SEED, config=rcfg)
    got = tc.repartition_assignment(tg, prof, seed=SEED, config=cfg)
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "profile.json"
    path.write_text(json.dumps(prof))
    np.testing.assert_array_equal(
        tc.repartition_assignment(tg, str(path), seed=SEED, config=cfg), want)
    new = tc.repartition(tpg := both[3], prof, seed=SEED, config=cfg)
    assert new.scheme == "waw" and new.k == tpg.k
    np.testing.assert_array_equal(new.assignment, want)


def test_bad_profiles_raise_like_the_reference(both, opat_profile):
    tg = both[2]
    with pytest.raises(ValueError, match="partitions"):
        tc.load_profile({"k": 4})
    with pytest.raises(ValueError, match="assignment"):
        tc.repartition_assignment(tg, {k: v for k, v in opat_profile.items()
                                       if k != "assignment"})
    with pytest.raises(ValueError, match="boundary_gain"):
        tc.RepartitionConfig(boundary_gain=0)


@pytest.mark.parametrize("engine", ["opat", "traditional"])
def test_session_repartition_matches_reference(both, engine):
    """GraphSession.repartition on the profile each session served: the
    same summary and assignment, then the same answers, loads, iterations
    and store counters on the new layout, and counters restarted."""
    g, pg, tg, tpg, dqs, tdqs = both
    ref, port = _sessions(both, engine)
    _serve_equal(ref, port, dqs, tdqs)
    assert port.workload_profile() == ref.workload_profile()
    info = port.repartition(seed=SEED)
    assert info == ref.repartition(seed=SEED)
    assert info["scheme"] == "waw" and info["round"] == 1 == port.repartitions
    np.testing.assert_array_equal(port.pg.assignment, ref.pg.assignment)
    assert port.workload_profile()["queries_served"] == 0
    assert port.load_stats.to_dict() == tc.LoadStats().to_dict()
    _serve_equal(ref, port, dqs, tdqs)
    assert port.workload_profile() == ref.workload_profile()
    for tdq, dq in zip(tdqs, dqs):
        np.testing.assert_array_equal(port.submit(tdq).answers,
                                      match_disjunctive(g, dq, q_pad=8))


@pytest.fixture(scope="module")
def mr_reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("mr-repartition") / "ref.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", MR_SCRIPT, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_mapreduce_repartition_matches_reference(both, mr_reference):
    """MapReduceMP (no per-partition load counters, so only the
    co-traversal pull): the same profile, summary and assignment, and the
    same answers, iterations and counters before and after the rebind."""
    tpg, tdqs = both[3], both[5]
    port = tc.GraphSession(pg=tpg, engine="mapreduce", seed=1,
                           config=tc.EngineConfig(cap=CAP), device="cpu")

    def serve(want):
        for tdq, w in zip(tdqs, want):
            r = port.submit(tdq)
            assert r.answers.tolist() == w["answers"], tdq.name
            assert r.reports[0].stats.iterations == w["iterations"], tdq.name
            assert r.reports[0].stats.loads == w["loads"] == []
            assert r.load_stats.to_dict() == w["load_stats"], tdq.name

    serve(mr_reference["before"])
    assert port.workload_profile() == mr_reference["profile"]
    assert port.workload_profile()["partition_counters_observed"] is False
    assert port.repartition(seed=SEED) == mr_reference["info"]
    assert port.pg.assignment.astype(int).tolist() == mr_reference["assignment"]
    serve(mr_reference["after"])
    assert port.workload_profile() == mr_reference["profile_after"]


def test_repartition_invalidates_the_store_and_stacked_bundles(both):
    """The rebind closes the old store (both tiers) and builds a fresh one:
    no single-partition entry or stacked bundle of the old layout stays."""
    port = _sessions(both, "traditional")[1]
    for tdq in both[5]:
        port.submit(tdq)
    old = port.store
    assert any(isinstance(k, tuple) for k in old.resident_keys())
    port.repartition(seed=SEED)
    assert port.store is not old and port.engine.store is port.store
    assert old.resident_keys() == [] and port.store.resident_keys() == []
    assert port.store.pg is port.pg and port.engine.pg is port.pg


def test_opened_session_drops_its_backing_and_can_be_resaved(both, tmp_path):
    """repartition() on a disk-opened session: the backing goes (the store
    holds the new layout in RAM, with no disk traffic), the old directory
    stays as it was, and save() writes the new layout, which both packages
    open and serve with the oracle's answers."""
    g, pg, tg, tpg, dqs, tdqs = both
    gdir = str(tmp_path / "orig")
    tc.GraphSession(pg=tpg, device="cpu").save(gdir)
    port = tc.GraphSession.open(gdir, seed=1, host_cache_parts=2,
                                config=tc.EngineConfig(cap=CAP), device="cpu")
    for tdq in tdqs:
        port.submit(tdq)
    assert port.load_stats.disk_reads > 0
    old_manifest = DiskCatalog(gdir).manifest
    info = port.repartition(seed=SEED)
    assert info["scheme"] == "waw"
    assert not port.out_of_core and port.store.backing is None
    assert port.generation is None
    refs = {dq.name: match_disjunctive(g, dq, q_pad=8) for dq in dqs}
    for tdq in tdqs:
        np.testing.assert_array_equal(port.submit(tdq).answers, refs[tdq.name])
    assert port.load_stats.disk_reads == 0
    assert DiskCatalog(gdir).manifest == old_manifest
    new_dir = str(tmp_path / "waw")
    manifest = port.save(new_dir)
    assert manifest["scheme"] == "waw" and manifest["generation"] == 0
    reopened = tc.GraphSession.open(new_dir, seed=1, config=tc.EngineConfig(cap=CAP),
                                    device="cpu")
    ref = RefSession.open(new_dir, seed=1, config=RefConfig(cap=CAP))
    assert reopened.scheme == ref.scheme == "waw"
    for tdq, dq in zip(tdqs, dqs):
        a, b = reopened.submit(tdq), ref.submit(dq)
        np.testing.assert_array_equal(a.answers, refs[tdq.name])
        np.testing.assert_array_equal(a.answers, b.answers)
        assert a.load_stats.to_dict() == b.load_stats.to_dict(), tdq.name
