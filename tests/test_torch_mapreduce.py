"""The PyTorch port's MapReduceMP on a part mesh against the JAX
package's SPMD engine, on the CPU.

At P = 4 the reference needs four devices, so it runs once in a
subprocess with four forced host devices (the pattern of
``tests/test_mapreduce_multidev.py``) and writes its results to an
``.npz``; the port runs in this process on the same graph, vertex
assignment and queries, on four part meshes whose shards all lie on the
CPU (``MESHES``: one shard of four lanes, four shards of one, two of two,
and the uneven one + three), each held to the same reference.  At P = 1
both run in this process, on both of the reference's paths (jnp and the
Pallas kernel).  Every comparison is exact: answers, ``n_iterations``, the
per-partition yield counters and the load counts.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compat import make_part_mesh
from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import build_catalog as ref_catalog, build_partitions as ref_build_partitions
from repro.core import generate_plan as ref_generate_plan, match_query
from repro.core.mapreduce_mp import MapReduceMPEngine as RefMapReduce
from repro.data.generators import subgen_like_graph as ref_subgen_graph
from repro.data.generators import subgen_queries as ref_subgen_queries

import repro_torch.core as tc
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.core.mapreduce_mp import unique_rows
from repro_torch.core.query import make_path_query
from repro_torch.data.generators import subgen_queries

CAP = 4096
# (m_limit, heuristic) settings held to the 4-device reference; budgets run
# under the first on fresh engines, and a quota of 8 rows per destination on
# its own engine
CASES = [(4, "max-sn"), (2, "max-sn"), (2, "min-sn"), (2, "max-yield")]
BUDGETS = (1, 5)
QUOTA = 8
TINY_CAP = 64
# every query runs under CASES[0] and the budgets; the other settings run
# the queries whose plans share one compiled reference program (Q5's plan
# is a second one), P3 among them: the query whose rows span partitions
# enough to make the gating and the quota bite
SUBSET = ("Q4", "Q6", "P3")
# the session runs' per-query budgets (subgen's three queries, then P3)
SESSION_BUDGETS = [None, 2, None, None]
# the port's part meshes: each shard's mapper ids, every shard on the CPU
MESHES = {"1x4": [[0, 1, 2, 3]], "4x1": [[0], [1], [2], [3]],
          "2x2": [[0, 1], [2, 3]], "1+3": [[0], [1, 2, 3]]}

REF_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.compat import make_part_mesh
    from repro.core import (EngineConfig, GraphSession, build_catalog,
                            build_partitions, generate_plan, partition_graph)
    from repro.core.mapreduce_mp import MapReduceMPEngine
    from repro.core.query import make_path_query
    from repro.data.generators import subgen_like_graph, subgen_queries

    CAP, CASES, BUDGETS, QUOTA, TINY_CAP, SUBSET, SESSION_BUDGETS = {consts}
    g = subgen_like_graph(n_nodes=250, n_edges=700, n_embed=10, seed=3)
    assign = partition_graph(g, 4, "kway_shem")
    pg = build_partitions(g, assign, 4)
    cat = build_catalog(g)
    mesh = make_part_mesh(4)
    queries = ([dq.disjuncts[0] for dq in subgen_queries(g)]
               + [make_path_query(["?"] * 3, ["?"] * 2, name="P3")])
    plans = [generate_plan(q, g, cat) for q in queries]
    out = {{"assign": assign}}

    def record(tag, eng, K=None, names=None):
        for q, plan in zip(queries, plans):
            if names is not None and q.name not in names:
                continue
            r = eng.run(plan, max_answers=K)
            key = f"{{tag}}/{{q.name}}"
            out[key + "/answers"] = r.answers
            out[key + "/n_iterations"] = np.int64(r.n_iterations)
            out[key + "/completed_from"] = r.completed_from
            out[key + "/spawned_from"] = r.spawned_from
            out[key + "/loads"] = np.array([r.stats.cold_loads, r.stats.warm_loads,
                                            r.stats.bytes_cold])

    for m_limit, heur in CASES:
        eng = MapReduceMPEngine(pg, mesh, EngineConfig(cap=CAP),
                                m_limit=m_limit, heuristic=heur)
        if (m_limit, heur) == CASES[0]:
            record(f"m{{m_limit}}_{{heur}}", eng)
        else:
            record(f"m{{m_limit}}_{{heur}}", eng, names=SUBSET)
    for K in BUDGETS:
        record(f"K{{K}}", MapReduceMPEngine(pg, mesh, EngineConfig(cap=CAP)), K)
    record("quota", MapReduceMPEngine(pg, mesh, EngineConfig(cap=CAP),
                                      quota_per_dest=QUOTA), names=SUBSET)
    try:
        MapReduceMPEngine(pg, mesh, EngineConfig(cap=TINY_CAP),
                          quota_per_dest=QUOTA).run(plans[-1])
        out["tiny_cap_raised"] = np.bool_(False)
    except RuntimeError as e:
        out["tiny_cap_raised"] = np.bool_("overflow" in str(e))

    # the session in RAM (submits, then the sequential submit_many drain),
    # then the same graph saved and opened through a one-partition host tier
    def served(res):
        return {{"answers": res.answers.tolist(),
                "iterations": res.reports[0].stats.iterations,
                "load_stats": res.load_stats.to_dict()}}

    sessions = {{}}
    sess = GraphSession(pg=pg, engine="mapreduce", mesh=mesh, seed=1,
                        config=EngineConfig(cap=CAP))
    sessions["ram"] = {{
        "submit": [served(sess.submit(q)) for q in queries],
        "many": [served(r) for r in sess.submit_many(
            queries, max_answers=SESSION_BUDGETS).results],
        "completed": sess._completed.tolist(),
        "spawned": sess._spawned.tolist(),
        "session": sess.load_stats.to_dict()}}
    sess.save(sys.argv[2])
    opened = GraphSession.open(sys.argv[2], engine="mapreduce", mesh=mesh, seed=1,
                               host_cache_parts=1, config=EngineConfig(cap=CAP))
    sessions["opened"] = {{
        "submit": [served(opened.submit(q)) for q in queries],
        "session": opened.load_stats.to_dict()}}
    out["sessions"] = np.array(json.dumps(sessions))
    np.savez(sys.argv[1], **out)
""").format(consts=repr((CAP, CASES, BUDGETS, QUOTA, TINY_CAP, SUBSET,
                         SESSION_BUDGETS)))


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


def _port_graph(g):
    return graph_from_arrays(node_label=g.node_label, node_value=g.node_value,
                             edge_src=g.edge_src, edge_dst=g.edge_dst,
                             edge_label=g.edge_label,
                             edge_directed=g.edge_directed,
                             node_vocab=_vocab(g.node_vocab),
                             edge_vocab=_vocab(g.edge_vocab))


def _port_queries(tg):
    return ([dq.disjuncts[0] for dq in subgen_queries(tg)]
            + [make_path_query(["?"] * 3, ["?"] * 2, name="P3")])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The 4-device reference's results, from one subprocess, and the
    graph directory its session saved (``"gdir"``)."""
    tmp = tmp_path_factory.mktemp("mapreduce")
    out, gdir = tmp / "ref.npz", tmp / "graph"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(out), str(gdir)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as f:
        got = {k: f[k] for k in f.files}
    got["sessions"] = json.loads(str(got["sessions"]))
    got["gdir"] = str(gdir)
    return got


@pytest.fixture(scope="module")
def port4(reference):
    """(graph, pg, catalog, queries) of the port, on the reference's graph
    and vertex assignment."""
    tg = _port_graph(ref_subgen_graph(n_nodes=250, n_edges=700, n_embed=10, seed=3))
    tpg = partitioned_graph_from_arrays(tg, reference["assign"], 4, "kway_shem")
    return tg, tpg, tc.build_catalog(tg), _port_queries(tg)


def part_mesh(name):
    """The ``MESHES`` layout ``name`` as a PartMesh on the CPU."""
    return tc.PartMesh(tuple(("cpu", pids) for pids in MESHES[name]))


def _assert_same(res, reference, key):
    np.testing.assert_array_equal(res.answers, reference[key + "/answers"], err_msg=key)
    assert res.n_iterations == int(reference[key + "/n_iterations"]), key
    for f in ("completed_from", "spawned_from"):
        got = getattr(res, f)
        assert got.dtype == np.int64 and got.shape == (4,), (key, f)
        np.testing.assert_array_equal(got, reference[key + f"/{f}"], err_msg=(key, f))
    st = res.stats
    assert [st.cold_loads, st.warm_loads, st.bytes_cold] \
        == reference[key + "/loads"].tolist(), key


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("m_limit,heuristic", CASES)
def test_matches_four_device_reference(reference, port4, m_limit, heuristic, mesh):
    tg, tpg, cat, queries = port4
    eng = tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=CAP), m_limit=m_limit,
                               heuristic=heuristic, device="cpu", mesh=part_mesh(mesh))
    if (m_limit, heuristic) != CASES[0]:
        queries = [q for q in queries if q.name in SUBSET]
    for q in queries:
        _assert_same(eng.run(tc.generate_plan(q, tg, cat)), reference,
                     f"m{m_limit}_{heuristic}/{q.name}")
    assert eng.step_launches == eng.batched_iters * len(MESHES[mesh])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("K", BUDGETS)
def test_answer_budget_matches_four_device_reference(reference, port4, K, mesh):
    tg, tpg, cat, queries = port4
    eng = tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=CAP), device="cpu",
                               mesh=part_mesh(mesh))
    for q in queries:
        res = eng.run(tc.generate_plan(q, tg, cat), max_answers=K)
        _assert_same(res, reference, f"K{K}/{q.name}")
        assert res.answers.shape[0] <= K


@pytest.mark.parametrize("mesh", MESHES)
def test_backpressure_matches_four_device_reference(reference, port4, mesh):
    """A quota of 8 rows per destination holds P3's spanning rows back
    over several iterations: the placement of every held row matters."""
    tg, tpg, cat, queries = port4
    eng = tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=CAP), quota_per_dest=QUOTA,
                               device="cpu", mesh=part_mesh(mesh))
    assert eng.quota == QUOTA
    free = tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=CAP), device="cpu",
                                mesh=part_mesh(mesh))
    for q in [q for q in queries if q.name in SUBSET]:
        plan = tc.generate_plan(q, tg, cat)
        res = eng.run(plan)
        _assert_same(res, reference, f"quota/{q.name}")
        if q.name == "P3":
            assert res.n_iterations > free.run(plan).n_iterations


@pytest.mark.parametrize("mesh", MESHES)
def test_overflow_raises_like_the_reference(reference, port4, mesh):
    tg, tpg, cat, queries = port4
    assert bool(reference["tiny_cap_raised"])
    eng = tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=TINY_CAP),
                               quota_per_dest=QUOTA, device="cpu", mesh=part_mesh(mesh))
    with pytest.raises(RuntimeError, match="overflow"):
        eng.run(tc.generate_plan(queries[-1], tg, cat))


def test_random_sn_gated_matches_oracle(port4):
    """RANDOM-SN under m_limit < P draws its lane order from a torch
    generator (not the reference's threefry stream): held to the oracle,
    and the same seed gives the same run."""
    tg, tpg, cat, queries = port4
    eng = tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=CAP), m_limit=2,
                               heuristic="random-sn", device="cpu")
    for q in queries:
        plan = tc.generate_plan(q, tg, cat)
        res = eng.run(plan, seed=7)
        np.testing.assert_array_equal(res.answers, tc.match_query(tg, q, q_pad=8),
                                      err_msg=q.name)
        again = eng.run(plan, seed=7)
        assert again.n_iterations == res.n_iterations, q.name
        np.testing.assert_array_equal(again.completed_from, res.completed_from)


@pytest.mark.parametrize("mesh", [m for m in MESHES if m != "1x4"])
def test_random_sn_gated_equals_one_shard_on_every_mesh(port4, mesh):
    """Gated RANDOM-SN on a multi-shard mesh: every device draws the same
    permutation, so the run equals the one-shard run exactly (answers,
    iterations, yield counters) and the oracle."""
    tg, tpg, cat, queries = port4
    one, many = (tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=CAP), m_limit=2,
                                      heuristic="random-sn", device="cpu",
                                      mesh=part_mesh(m)) for m in ("1x4", mesh))
    for q in queries:
        plan = tc.generate_plan(q, tg, cat)
        want, got = one.run(plan, seed=7), many.run(plan, seed=7)
        np.testing.assert_array_equal(got.answers, tc.match_query(tg, q, q_pad=8),
                                      err_msg=q.name)
        np.testing.assert_array_equal(got.answers, want.answers, err_msg=q.name)
        assert got.n_iterations == want.n_iterations, q.name
        np.testing.assert_array_equal(got.completed_from, want.completed_from)
        np.testing.assert_array_equal(got.spawned_from, want.spawned_from)


def test_run_request_rejects_other_heuristic(port4):
    tg, tpg, cat, queries = port4
    eng = tc.MapReduceMPEngine(tpg, tc.EngineConfig(cap=CAP), device="cpu")
    plan = tc.generate_plan(queries[0], tg, cat)
    with pytest.raises(ValueError, match="heuristic"):
        eng.run_request(tc.RunRequest(plan=plan, heuristic="min-sn"))
    rep = eng.run_request(tc.RunRequest(plan=plan, heuristic="max-sn"))
    assert rep.engine == "mapreduce" and rep.stats.loads == []
    assert rep.stats.iterations == rep.extra["n_iterations"]
    assert eng.quota == max(8, CAP // 16) and eng.m_limit == 4


def test_unique_rows_exact():
    """The device-side distinct-row count equals np.unique(axis=0) over each
    lane's prefix, with duplicates and -1 padding in the rows."""
    rng = np.random.default_rng(0)
    L, N, Q = 3, 200, 5
    base = rng.integers(-1, 4, size=(L, 40, Q)).astype(np.int32)
    faa = base[:, rng.integers(0, 40, size=N)]
    faa[:, :, 3:] = -1
    n = np.array([0, 1, 137])
    got = unique_rows(torch.from_numpy(faa), torch.from_numpy(n))
    want = [np.unique(faa[i, : n[i]], axis=0).shape[0] for i in range(L)]
    assert got.tolist() == want


@pytest.fixture(scope="module")
def single(small_graph):
    """k = 1 on the shared small graph: (reference pg, port graph, port pg)."""
    pg1 = ref_build_partitions(small_graph,
                               np.zeros(small_graph.n_nodes, np.int32), 1)
    tg = _port_graph(small_graph)
    return pg1, tg, partitioned_graph_from_arrays(tg, pg1.assignment, 1, pg1.scheme)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_one_lane_matches_reference(small_graph, single, use_pallas):
    pg1, tg, tpg1 = single
    ref = RefMapReduce(pg1, make_part_mesh(1),
                       RefConfig(cap=CAP, use_pallas=use_pallas))
    eng = tc.MapReduceMPEngine(tpg1, tc.EngineConfig(cap=CAP), device="cpu")
    rcat, cat = ref_catalog(small_graph), tc.build_catalog(tg)
    for dq, tdq in zip(ref_subgen_queries(small_graph), subgen_queries(tg)):
        want = ref.run(ref_generate_plan(dq.disjuncts[0], small_graph, rcat))
        got = eng.run(tc.generate_plan(tdq.disjuncts[0], tg, cat))
        np.testing.assert_array_equal(got.answers, want.answers, err_msg=dq.name)
        np.testing.assert_array_equal(
            got.answers, match_query(small_graph, dq.disjuncts[0], q_pad=8))
        assert got.n_iterations == want.n_iterations, dq.name
        np.testing.assert_array_equal(got.completed_from, want.completed_from)
        np.testing.assert_array_equal(got.spawned_from, want.spawned_from)


def test_session_submit_and_drain_match_reference(small_graph, single, tmp_path):
    """GraphSession(engine="mapreduce") at k = 1: submit, the yield
    counters and profile it absorbs, submit_many through the sequential
    drain, and the drain bounded by max_rounds, each equal to the
    reference session's."""
    pg1, tg, tpg1 = single
    ref = RefSession(pg=pg1, engine="mapreduce", seed=1, config=RefConfig(cap=CAP))
    port = tc.GraphSession(pg=tpg1, engine="mapreduce", seed=1,
                           config=tc.EngineConfig(cap=CAP), device="cpu")
    assert isinstance(port.engine, tc.MapReduceMPEngine)
    assert not port.observes_partition_counters
    assert (port.out_of_core, port.mutable, port.generation) == (False, False, None)
    dqs, tdqs = ref_subgen_queries(small_graph), subgen_queries(tg)
    for dq, tdq in zip(dqs, tdqs):
        a, b = port.submit(tdq), ref.submit(dq)
        np.testing.assert_array_equal(a.answers, b.answers, err_msg=dq.name)
        assert a.load_stats.to_dict() == b.load_stats.to_dict(), dq.name
        assert a.reports[0].stats.iterations == b.reports[0].stats.iterations
    for name in ("_loads", "_completed", "_spawned", "_cospan", "_vertex_span"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name),
                                      err_msg=name)
    budgets = [None, 2, None]
    got = port.submit_many(tdqs, max_answers=budgets)
    want = ref.submit_many(dqs, max_answers=budgets)
    assert not got.shared and not want.shared
    assert (got.loads, got.batch_sizes) == (want.loads, want.batch_sizes)
    assert got.load_stats.to_dict() == want.load_stats.to_dict()
    for a, b in zip(got.results, want.results):
        assert (a.name, a.qid) == (b.name, b.qid)
        np.testing.assert_array_equal(a.answers, b.answers, err_msg=a.name)
        assert a.load_stats.to_dict() == b.load_stats.to_dict(), a.name
        for ra, rb in zip(a.reports, b.reports):
            assert ra.stats.iterations == rb.stats.iterations, a.name
            assert ra.stats.answers_requested == rb.stats.answers_requested
    assert port.load_stats.to_dict() == ref.load_stats.to_dict()
    assert port.workload_profile() == ref.workload_profile()
    port.save_profile(str(tmp_path / "profile.json"))
    assert json.loads((tmp_path / "profile.json").read_text()) == port.workload_profile()

    # a streaming scheduler: run(max_rounds=1) serves one whole query on the
    # sequential drain and leaves the rest pending, as the reference's does
    rsched, psched = ref.scheduler(), port.scheduler()
    for dq, tdq in zip(dqs, tdqs):
        rsched.admit(dq)
        psched.admit(tdq)
    for rounds in (1, None):
        want, got = rsched.run(max_rounds=rounds), psched.run(max_rounds=rounds)
        assert [r.name for r in got.results] == [r.name for r in want.results]
        assert got.load_stats.to_dict() == want.load_stats.to_dict()
        for a, b in zip(got.results, want.results):
            np.testing.assert_array_equal(a.answers, b.answers, err_msg=a.name)
    assert len(got.results) == len(dqs) - 1 and psched.n_pending == 0
    rsched.close()


def test_session_four_lanes_matches_reference(reference, port4):
    """The k = 4 session serves through the four-lane engine: each query's
    answers and the yield counters it absorbs equal the reference's."""
    tg, tpg, cat, queries = port4
    sess = tc.GraphSession(pg=tpg, engine="mapreduce", config=tc.EngineConfig(cap=CAP),
                           device="cpu")
    comp = np.zeros(4, np.int64)
    for q in queries:
        res = sess.submit(q)
        key = f"m4_max-sn/{q.name}"
        np.testing.assert_array_equal(res.answers, reference[key + "/answers"])
        assert res.reports[0].extra["n_iterations"] == int(reference[key + "/n_iterations"])
        comp += reference[key + "/completed_from"]
    np.testing.assert_array_equal(sess._completed, comp)
    assert sess.load_stats.cold_loads == 1 and sess.load_stats.warm_loads == len(queries) - 1


def _assert_served(res, want, name):
    assert res.answers.tolist() == want["answers"], name
    assert res.reports[0].stats.iterations == want["iterations"], name
    assert res.load_stats.to_dict() == want["load_stats"], name


@pytest.mark.parametrize("mesh", MESHES)
def test_session_on_a_mesh_matches_reference_session(reference, port4, mesh):
    """GraphSession(mesh=) against the reference's session on its four
    devices: every submit, the sequential submit_many drain (the mesh
    passes through to it), the yield counters the session absorbs and
    its load counters."""
    tg, tpg, cat, queries = port4
    want = reference["sessions"]["ram"]
    sess = tc.GraphSession(pg=tpg, engine="mapreduce", seed=1, mesh=part_mesh(mesh),
                           config=tc.EngineConfig(cap=CAP), device="cpu")
    assert sess.engine.mesh == part_mesh(mesh)
    for q, w in zip(queries, want["submit"]):
        _assert_served(sess.submit(q), w, q.name)
    launches = sess.engine.step_launches
    rep = sess.submit_many(queries, max_answers=SESSION_BUDGETS)
    for r, w in zip(rep.results, want["many"]):
        _assert_served(r, w, r.name)
    iters = sum(r.reports[0].stats.iterations for r in rep.results)
    assert sess.engine.step_launches - launches == iters * len(MESHES[mesh])
    assert sess._completed.tolist() == want["completed"]
    assert sess._spawned.tolist() == want["spawned"]
    assert sess.load_stats.to_dict() == want["session"]


@pytest.mark.parametrize("mesh", MESHES)
def test_opened_session_on_a_mesh_matches_reference_open(reference, mesh):
    """GraphSession.open(mesh=, host_cache_parts=1) on the reference's
    saved directory: the stacked bundle placed over the mesh through a
    one-partition host tier; each query's answers, iterations and every
    load counter (disk reads included) equal the reference's open."""
    want = reference["sessions"]["opened"]
    sess = tc.GraphSession.open(reference["gdir"], engine="mapreduce", seed=1,
                                mesh=part_mesh(mesh), host_cache_parts=1,
                                config=tc.EngineConfig(cap=CAP), device="cpu")
    for q, w in zip(_port_queries(sess.graph), want["submit"]):
        _assert_served(sess.submit(q), w, q.name)
    assert sess.load_stats.to_dict() == want["session"]
    assert sess.load_stats.disk_reads >= 4
