"""The PyTorch port's SLO serving front end (``repro_torch.serving``) and
the scheduler's urgency against the JAX package's, on the CPU.

Both packages serve the same graph, partitions and queries (carried over
with ``repro_torch.convert``).  The cost model must price every plan the
same, ``parse_slo_spec`` and ``SloBurnMonitor`` must agree, and with no
SLO classes the front end must equal ``submit_many``.  Under instant
replay (``replay_speed=0``) every admission, degrade, defer and shed
decision comes from the uncalibrated cost model and the predicted
backlog, never the wall clock, so each outcome's status, flags, budget
and shed reason, the counters and the served answers must equal the
reference front end's on OPAT and TraditionalMP.  Latencies and deadline
attainment are wall-clock and are not compared.  MapReduceMP needs four
devices in the reference, so its front end is held to the oracle.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import generate_plan as ref_generate_plan
from repro.core import match_disjunctive
from repro.data.generators import subgen_queries as ref_subgen_queries
from repro.obs.profile import SloBurnMonitor as RefBurn
from repro import serving as ref_serving

import repro_torch.core as tc
from repro_torch import serving
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.data.generators import subgen_queries
from repro_torch.obs.profile import SloBurnMonitor

CAP = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes at once).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(small_graph, small_pg):
    """(reference graph, reference pg, port graph, port pg, reference
    queries, port queries, oracle answers)."""
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
    dqs, tdqs = ref_subgen_queries(g), subgen_queries(tg)
    refs = {dq.name: match_disjunctive(g, dq, q_pad=8) for dq in dqs}
    return g, small_pg, tg, tpg, dqs, tdqs, refs


@pytest.fixture(scope="module")
def sessions(both):
    """One (reference, port) session pair per engine, shared by every test
    here, so each reference engine traces its evaluator once."""
    g, pg, tg, tpg, *_ = both
    out = {}
    for engine in ("opat", "traditional"):
        out[engine] = (
            RefSession(pg=pg, engine=engine, seed=1, processors=2,
                       config=RefConfig(cap=CAP)),
            tc.GraphSession(pg=tpg, engine=engine, seed=1, processors=2,
                            config=tc.EngineConfig(cap=CAP), device="cpu"))
    return out


# ---------------------------------------------------------------------------
# the cost model, the SLO spec and the burn monitor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [None, 0, 4, 10_000])
def test_cost_model_prices_like_reference(both, budget):
    """plan_units, predict_plans (units, loads, latency, bucket) and the
    calibrated buckets equal the reference's on the same partitions."""
    g, pg, tg, tpg, dqs, tdqs, _ = both
    ref_cm, cm = ref_serving.CostModel(pg), serving.CostModel(tpg)
    rcat, cat = RefSession(pg=pg).catalog, tc.build_catalog(tg)
    for dq, tdq in zip(dqs, tdqs):
        rplans = [ref_generate_plan(q, g, rcat) for q in dq.disjuncts]
        plans = [tc.generate_plan(q, tg, cat) for q in tdq.disjuncts]
        for rp, p in zip(rplans, plans):
            assert cm.plan_units(p, budget) == ref_cm.plan_units(rp, budget)
            assert serving.required_partition_mask(tpg, p).tolist() == \
                ref_serving.required_partition_mask(pg, rp).tolist()
        want, got = ref_cm.predict_plans(rplans, budget), cm.predict_plans(plans, budget)
        assert got.__dict__ == want.__dict__, dq.name
        # the same observations calibrate the same buckets
        for lat in (0.01, 0.3, 0.02):
            assert cm.observe(got, lat) == ref_cm.observe(want, lat)
        assert cm.predict_plans(plans, budget).__dict__ == \
            ref_cm.predict_plans(rplans, budget).__dict__
    assert cm.snapshot() == ref_cm.snapshot()


@pytest.mark.parametrize("spec", ["interactive=0.5,batch=5,exhaustive=inf",
                                  "batch=2, gold=0.1 ,exhaustive=none",
                                  "x=1", "a", "a=0", "", "interactive=-1"])
def test_parse_slo_spec_matches_reference(spec):
    try:
        want = ref_serving.parse_slo_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            serving.parse_slo_spec(spec)
        assert str(got.value) == str(e)
        return
    got = serving.parse_slo_spec(spec)
    assert [c.__dict__ for c in got] == [c.__dict__ for c in want]
    assert [c.__dict__ for c in serving.default_slo_classes()] == \
        [c.__dict__ for c in ref_serving.default_slo_classes()]


def test_slo_burn_monitor_matches_reference():
    rng = np.random.default_rng(4)
    ref, port = RefBurn(window=7, error_budget=0.2), SloBurnMonitor(window=7, error_budget=0.2)
    for _ in range(60):
        cls, met = ("a", "b", "c")[int(rng.integers(0, 3))], bool(rng.random() < 0.7)
        ref.observe(cls, met)
        port.observe(cls, met)
        assert port.snapshot() == ref.snapshot()
    assert port.burn_rate("zz") == ref.burn_rate("zz") == 0.0
    for bad in ({"window": 0}, {"error_budget": 0.0}, {"error_budget": 1.5}):
        with pytest.raises(ValueError):
            SloBurnMonitor(**bad)


# ---------------------------------------------------------------------------
# the front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["opat", "traditional", "mapreduce"])
def test_no_slo_frontend_equals_submit_many(both, engine):
    """With no SLO classes the front end is ``submit_many``: the same
    answers, load sequence, batch sizes and counters, from two sessions
    that start alike."""
    *_, tpg, _, tdqs, refs = both
    budgets = [None, 5, None, 2]
    queries = tdqs + tdqs[:1]

    def session():
        return tc.GraphSession(pg=tpg, engine=engine, seed=1, processors=2,
                               config=tc.EngineConfig(cap=CAP), device="cpu")
    a, b = session(), session()
    rep = a.frontend(slo_classes=[]).serve(
        [serving.Request(q, max_answers=k) for q, k in zip(queries, budgets)])
    want = b.submit_many(queries, max_answers=budgets)
    assert rep.counters == {"arrived": 4, "admitted": 4, "served": 4}
    assert rep.schedule.loads == want.loads
    assert rep.schedule.batch_sizes == want.batch_sizes
    assert rep.schedule.load_stats.to_dict() == want.load_stats.to_dict()
    for o, r in zip(rep.outcomes, want.results):
        assert o.status == "ok" and o.name == r.name
        np.testing.assert_array_equal(o.result.answers, r.answers)
        assert o.result.load_stats.to_dict() == r.load_stats.to_dict()
    assert "serving" not in a.workload_profile()
    assert a.workload_profile() == b.workload_profile()


OUTCOME_KEYS = ("name", "slo_class", "arrival_s", "status", "shed_reason",
                "degraded", "deferred", "max_answers", "predicted_latency_s",
                "deadline_s", "finished_round")


def _frontend(pkg, sess, scenario):
    """Each scenario's front end over ``sess``, built from package ``pkg``
    (the reference's serving module or the port's) with a fresh cost
    model, so decisions read only the uncalibrated model."""
    if scenario == "default":
        return sess.frontend()
    cm = pkg.CostModel(sess.pg, default_rate_s=2.0)
    # at 2 s a unit the uncalibrated model prices these queries at 5-19 s:
    # a 12 s batch deadline degrades some and sheds others, 4 ms sheds all
    batch_deadline = 12.0 if scenario == "degrade" else 0.004
    classes = [pkg.SLOClass("interactive", deadline_s=60.0, priority=0),
               pkg.SLOClass("batch", deadline_s=batch_deadline, priority=1,
                            degradable=True, sheddable=True),
               pkg.SLOClass("exhaustive", deadline_s=math.inf, priority=2,
                            deferrable=True, sheddable=True)]
    policy = {"overload": "predictive", "degrade": "predictive",
              "deadline": "deadline", "never": "never"}[scenario]
    return sess.frontend(cost_model=cm, slo_classes=classes, shed_policy=policy)


def _requests(pkg, queries, scenario):
    """The four path queries (Q4 twice) x 4 repeats, classes round-robin
    over interactive / batch / exhaustive (all batch in "degrade"); the
    overload scenarios give every request a budget the degraded class can
    shrink."""
    reqs = []
    for i, q in enumerate((queries + queries[:1]) * 4):
        cls = ("batch" if scenario == "degrade"
               else ("interactive", "batch", "exhaustive")[i % 3])
        budget = None if scenario == "default" else (16 if i % 2 else 10_000)
        reqs.append(pkg.Request(q, slo_class=cls, max_answers=budget,
                                arrival_s=0.001 * i))
    return reqs


@pytest.mark.parametrize("scenario", ["default", "overload", "degrade", "deadline",
                                      "never"])
@pytest.mark.parametrize("engine", ["opat", "traditional"])
def test_instant_replay_decisions_match_reference(both, sessions, engine, scenario):
    """Every outcome's status, degraded / deferred, effective budget,
    shed reason, predicted latency and completion round, the counters,
    the shed reasons, the pump count, the served answers and the
    profile's serving counters equal the reference front end's."""
    *_, dqs, tdqs, refs = both
    ref, port = sessions[engine]
    want = _frontend(ref_serving, ref, scenario).serve(
        _requests(ref_serving, dqs, scenario))
    got = _frontend(serving, port, scenario).serve(
        _requests(serving, tdqs, scenario))
    assert [{k: getattr(o, k) for k in OUTCOME_KEYS} for o in got.outcomes] == \
        [{k: getattr(o, k) for k in OUTCOME_KEYS} for o in want.outcomes]
    assert got.counters == want.counters
    assert got.shed_by_reason == want.shed_by_reason
    assert got.rounds == want.rounds
    assert sum(got.counters[k] for k in ("served", "shed")) == got.counters["arrived"]
    for o, w in zip(got.outcomes, want.outcomes):
        if o.status == "shed":
            assert o.shed_reason and o.result is None
            continue
        np.testing.assert_array_equal(o.result.answers, w.result.answers)
        ref_rows = {tuple(r) for r in refs[o.name]}
        assert all(tuple(r) in ref_rows for r in o.result.answers)
        assert o.result.n_answers >= min(o.max_answers or len(ref_rows), len(ref_rows))
    if scenario in ("overload", "deadline"):
        assert got.counters["shed"]
    if scenario == "degrade":
        assert got.counters["shed"] and got.counters["degraded"]
    if scenario == "default":
        assert got.counters["deferred"]
    assert port.workload_profile()["serving"]["counters"] == \
        ref.workload_profile()["serving"]["counters"]
    assert sorted(got.slo_burn) == sorted(want.slo_burn)


def test_mapreduce_frontend_answers_match_oracle(both):
    """MapReduceMP behind the front end (the sequential drain): every
    served answer is the oracle's under its effective budget, every shed
    carries a reason, and the counters sum to the request count."""
    *_, tpg, _, tdqs, refs = both
    sess = tc.GraphSession(pg=tpg, engine="mapreduce", seed=1,
                           config=tc.EngineConfig(cap=CAP), device="cpu")
    for scenario in ("default", "overload"):
        rep = _frontend(serving, sess, scenario).serve(_requests(serving, tdqs, scenario))
        c = rep.counters
        assert c["served"] + c["shed"] == c["arrived"] == 16
        for o in rep.outcomes:
            ref = refs[o.name]
            if o.status == "shed":
                assert o.shed_reason
            elif o.max_answers is None:
                np.testing.assert_array_equal(o.result.answers, ref)
            else:
                rows = {tuple(r) for r in ref}
                assert all(tuple(r) in rows for r in o.result.answers)
                assert o.result.n_answers == min(o.max_answers, len(rows))


def test_scheduler_urgency_ranks_like_reference(both, sessions):
    """admit(urgency=) and set_urgency reach every job and steer the
    shared ranking exactly as in the reference: the same loads, batch
    sizes and answers; unknown qids are ignored."""
    *_, dqs, tdqs, _ = both
    ref, port = sessions["opat"]
    rs, ps = ref.scheduler(), port.scheduler()
    for s, queries in ((rs, dqs), (ps, tdqs)):
        for i, q in enumerate(queries):
            qid = s.admit(q, urgency=0.5 * i)
            assert all(j.urgency == 0.5 * i for j in s._admitted[qid].jobs)
        s.set_urgency(0, 40.0)
        s.set_urgency(999, 1.0)
        assert all(j.urgency == 40.0 for j in s._admitted[0].jobs)
    want, got = rs.run(), ps.run()
    rs.close(), ps.close()
    assert got.loads == want.loads and got.batch_sizes == want.batch_sizes
    for a, b in zip(got.results, want.results):
        assert a.qid == b.qid
        np.testing.assert_array_equal(a.answers, b.answers)
    with pytest.raises(RuntimeError, match="close"):
        ps.admit(tdqs[0])
