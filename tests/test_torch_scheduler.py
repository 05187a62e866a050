"""The PyTorch port's shared-load scheduler (``GraphSession.submit_many``)
against the JAX package's, on the CPU, for the OPAT and TraditionalMP
engines.

Both packages serve the same graph, partitions and queries (carried over
with ``repro_torch.convert``).  The reports must agree exactly: the
workload load sequence, batch sizes and store counters of the round, and
per query its answers, loads, iterations and participation counters.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import match_disjunctive
from repro.data.generators import subgen_queries as ref_subgen_queries

import repro_torch.core as tc
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.data.generators import subgen_queries

CAP = 1024
ENGINES = ["opat", "traditional"]


@pytest.fixture(scope="module")
def both(small_graph, small_pg):
    """(reference graph, reference pg, port graph, port pg)."""
    g = small_graph

    def vocab(v):
        return [v.str_of(i) for i in range(len(v))]
    tg = graph_from_arrays(node_label=g.node_label, node_value=g.node_value,
                           edge_src=g.edge_src, edge_dst=g.edge_dst,
                           edge_label=g.edge_label,
                           edge_directed=g.edge_directed,
                           node_vocab=vocab(g.node_vocab),
                           edge_vocab=vocab(g.edge_vocab))
    tpg = partitioned_graph_from_arrays(tg, small_pg.assignment, small_pg.k,
                                        small_pg.scheme)
    return g, small_pg, tg, tpg


def _sessions(both, engine):
    g, pg, tg, tpg = both
    ref = RefSession(pg=pg, engine=engine, seed=1, processors=2,
                     config=RefConfig(cap=CAP))
    port = tc.GraphSession(pg=tpg, engine=engine, seed=1, processors=2,
                           config=tc.EngineConfig(cap=CAP), device="cpu")
    return ref, port


def _assert_reports_equal(got, want):
    assert got.loads == want.loads
    assert got.batch_sizes == want.batch_sizes
    assert got.shared and want.shared
    assert got.load_stats.to_dict() == want.load_stats.to_dict()
    assert [r.name for r in got.results] == [r.name for r in want.results]
    for a, b in zip(got.results, want.results):
        np.testing.assert_array_equal(a.answers, b.answers, err_msg=a.name)
        assert a.qid == b.qid and a.generation is None
        assert a.load_stats.to_dict() == b.load_stats.to_dict(), a.name
        for ra, rb in zip(a.reports, b.reports):
            assert ra.stats.loads == rb.stats.loads, a.name
            assert ra.stats.iterations == rb.stats.iterations, a.name
            assert ra.stats.answers_requested == rb.stats.answers_requested
            for f in ("cold_loads", "warm_loads", "bytes_cold"):
                assert getattr(ra.stats, f) == getattr(rb.stats, f), (a.name, f)


def test_batch_bucket_powers_of_two():
    assert [tc.batch_bucket(n) for n in (1, 2, 3, 4, 5, 8, 9, 16)] == \
        [1, 2, 4, 4, 8, 8, 16, 16]


def test_rank_partitions_shared_scoring():
    rng = np.random.default_rng(0)
    waiting = {0: [(10, 0.01), (10, 0.01)], 1: [(5, 1.0)]}
    assert tc.rank_partitions_shared(tc.MAX_SN, waiting, rng)[0] == 0
    assert tc.rank_partitions_shared(tc.MAX_YIELD_SHARED, waiting, rng)[0] == 1
    with pytest.raises(ValueError):
        tc.rank_partitions_shared("min-sn", waiting, rng)


@pytest.mark.parametrize("engine", ENGINES)
def test_submit_many_matches_reference_and_sequential_submit(both, engine):
    """Two copies of every subgen query: the report equals the reference
    scheduler's, and every query's answers equal a sequential submit's and
    the whole-graph oracle."""
    g, _, tg, _ = both
    ref, port = _sessions(both, engine)
    want = ref.submit_many(ref_subgen_queries(g) * 2)
    got = port.submit_many(subgen_queries(tg) * 2)
    _assert_reports_equal(got, want)
    assert got.loads_per_query == want.loads_per_query
    seq = tc.GraphSession(pg=both[3], engine=engine, seed=1,
                          config=tc.EngineConfig(cap=CAP), device="cpu")
    for res, dq, rdq in zip(got.results, subgen_queries(tg) * 2,
                            ref_subgen_queries(g) * 2):
        np.testing.assert_array_equal(res.answers, seq.submit(dq).answers)
        np.testing.assert_array_equal(res.answers,
                                      match_disjunctive(g, rdq, q_pad=8))
    # the shared round loaded fewer partitions than the queries did alone
    assert got.n_loads < sum(r.n_loads for r in got.results)


@pytest.mark.parametrize("engine", ENGINES)
def test_submit_many_budgets_and_release_match_reference(both, engine):
    """A per-query budget list, with retired partitions released."""
    g, _, tg, _ = both
    ref, port = _sessions(both, engine)
    budgets = [1, None, 3, 2, 0, None]
    want = ref.submit_many(ref_subgen_queries(g) * 2, max_answers=budgets,
                           release_retired=True)
    got = port.submit_many(subgen_queries(tg) * 2, max_answers=budgets,
                           release_retired=True)
    _assert_reports_equal(got, want)
    for res, b in zip(got.results, budgets):
        if b is not None:
            assert res.n_answers <= b
    if engine == "opat":
        assert got.load_stats.released > 0


def test_budget_zero_does_no_loads(both):
    _, _, tg, _ = both
    for engine in ENGINES:
        sess = tc.GraphSession(pg=both[3], engine=engine, seed=1, device="cpu",
                               config=tc.EngineConfig(cap=CAP))
        report = sess.submit_many(subgen_queries(tg), max_answers=0)
        assert report.loads == [] and report.load_stats.misses == 0
        assert all(r.n_answers == 0 for r in report.results)


@pytest.mark.parametrize("engine", ENGINES)
def test_streaming_admission_two_rounds_matches_reference(both, engine):
    """Queries admitted after a run() are served by the next one, and
    ``max_rounds`` leaves the rest pending; both rounds equal the
    reference's."""
    g, _, tg, _ = both
    ref, port = _sessions(both, engine)
    reports = []
    for sess, qs in ((ref, ref_subgen_queries(g)), (port, subgen_queries(tg))):
        sched = sess.scheduler()
        sched.admit(qs[0])
        sched.admit(qs[1], max_answers=3)
        first = sched.run(max_rounds=1)
        pending = sched.n_pending
        waiters = sched.partition_waiters()
        sched.admit(qs[2])
        reports.append((first, pending, waiters, sched.run()))
    (w1, wp, ww, w2), (g1, gp, gw, g2) = reports
    assert (gp, gw) == (wp, ww) and gp > 0
    _assert_reports_equal(g1, w1)
    _assert_reports_equal(g2, w2)
    assert [r.qid for r in g2.results] == [0, 1, 2]


@pytest.mark.parametrize("engine", ENGINES)
def test_one_fused_launch_per_batched_loop(both, engine):
    """Every batched call's loop is one fused-step call over all its lanes,
    and the engine's batched_iters counts them."""
    from repro_torch.kernels import ops as kops
    _, _, tg, tpg = both
    sess = tc.GraphSession(pg=tpg, engine=engine, seed=1, device="cpu",
                           config=tc.EngineConfig(cap=CAP))
    calls = []
    inner = kops.frontier_step

    def counting(inv, wr, ws, lidx, sel, m, out):
        calls.append(sel.numel())          # rows of all lanes in one launch
        return inner(inv, wr, ws, lidx, sel, m, out)
    kops.frontier_step = counting
    try:
        sess.submit_many(subgen_queries(tg) * 2)
    finally:
        kops.frontier_step = inner
    assert sess.engine.batched_iters == len(calls) > 0
    assert max(calls) > sess.config.expand_block   # several lanes per launch


def test_submit_many_feeds_session_counters_like_submit(both):
    _, _, tg, tpg = both
    qs = subgen_queries(tg)
    seq = tc.GraphSession(pg=tpg, seed=1, device="cpu",
                          config=tc.EngineConfig(cap=CAP))
    for dq in qs:
        seq.submit(dq)
    sh = tc.GraphSession(pg=tpg, seed=1, device="cpu",
                         config=tc.EngineConfig(cap=CAP))
    sh.submit_many(qs)
    for name in ("_cospan", "_vertex_span", "_completed", "_spawned"):
        np.testing.assert_array_equal(getattr(sh, name), getattr(seq, name),
                                      err_msg=name)
    assert (sh._queries_served, sh._answers_served) == \
        (seq._queries_served, seq._answers_served)


def test_scheduler_argument_checks(both):
    sess = tc.GraphSession(pg=both[3], seed=1, device="cpu")
    with pytest.raises(ValueError):
        sess.scheduler(heuristic="min-sn")
    with pytest.raises(ValueError):
        sess.scheduler(fairness_gamma=-1.0)
    with pytest.raises(ValueError):
        sess.submit_many(subgen_queries(both[2]), max_answers=[1])
    sched = sess.scheduler(fairness_gamma=0.5)
    assert sched.fairness_gamma == 0.5 and sched.n_pending == 0
