"""The PyTorch port's evaluators (single and lane-batched), partition
store, OPAT and TraditionalMP engines and session against the JAX
package, on the CPU.

Both packages get identical inputs: the graph is made by the JAX
package's generator from a seed and carried into the port with
``repro_torch.convert``, partitions are rebuilt from the reference's
vertex assignment, and evaluator plans are carried field by field.  All
outputs are integers or masks, so every comparison is exact.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro.core import (EngineConfig as RefConfig, GraphSession as RefSession,
                        OPATEngine as RefOPAT, PartitionStore as RefStore,
                        build_catalog as ref_catalog,
                        generate_plan as ref_generate_plan,
                        make_partition_evaluator as ref_evaluator,
                        match_disjunctive, match_query)
from repro.core.engine import part_to_device_dict as ref_part_dict
from repro.core.plan import PlanArrays as RefPlanArrays
from repro.core.traditional_mp import TraditionalMPEngine as RefTMP
from repro.data.generators import subgen_queries as ref_subgen_queries

import repro_torch.core as tc
from repro_torch.convert import (graph_from_arrays, partitioned_graph_from_arrays,
                                 plan_arrays_from_numpy)
from repro_torch.core.engine import plan_to_device, ranked_slots
from repro_torch.core.opat import lane_outputs
from repro_torch.data.generators import subgen_queries

REPO = Path(__file__).resolve().parents[1]
HEURISTICS = ["max-sn", "min-sn", "random-sn", "max-yield"]
CAP = 1024


def _vocab(v):
    return [v.str_of(i) for i in range(len(v))]


@pytest.fixture(scope="module")
def both(small_graph, small_pg):
    """(reference graph, reference pg, port graph, port pg)."""
    g = small_graph
    tg = graph_from_arrays(node_label=g.node_label, node_value=g.node_value,
                           edge_src=g.edge_src, edge_dst=g.edge_dst,
                           edge_label=g.edge_label,
                           edge_directed=g.edge_directed,
                           node_vocab=_vocab(g.node_vocab),
                           edge_vocab=_vocab(g.edge_vocab))
    tpg = partitioned_graph_from_arrays(tg, small_pg.assignment, small_pg.k,
                                        small_pg.scheme)
    return g, small_pg, tg, tpg


def _queries(g, tg):
    """Reference and port subgen queries (first disjunct of each)."""
    return list(zip([dq.disjuncts[0] for dq in ref_subgen_queries(g)],
                    [dq.disjuncts[0] for dq in subgen_queries(tg)]))


def _plan_fields(pa):
    return {f.name: getattr(pa, f.name) for f in dataclasses.fields(pa)}


def test_partitions_equal(both):
    _, pg, _, tpg = both
    assert (tpg.node_pad, tpg.ell_width, tpg.k) == (pg.node_pad, pg.ell_width, pg.k)
    np.testing.assert_array_equal(tpg.g2l, pg.g2l)
    np.testing.assert_array_equal(tpg.owner, pg.owner)
    for p, tp in zip(pg.parts, tpg.parts):
        a, b = ref_part_dict(p), tc.engine.part_to_device_dict(tp)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_plans_equal(both):
    """The port's planner gives the reference's plan on the same graph."""
    g, _, tg, _ = both
    cat, tcat = ref_catalog(g), tc.build_catalog(tg)
    for q, tq in _queries(g, tg):
        a = RefPlanArrays.from_plan(ref_generate_plan(q, g, cat), pad_steps=12)
        b = tc.PlanArrays.from_plan(tc.generate_plan(tq, tg, tcat), pad_steps=12)
        for k, v in _plan_fields(a).items():
            np.testing.assert_array_equal(getattr(b, k), v, err_msg=k)


def _eval_both(ref_eval, port_eval, pg, tpg, pid, plan, in_rows, in_step,
               in_valid, seed_fresh):
    part = ref_part_dict(pg.parts[pid])
    want = ref_eval(part, pg.g2l[pid], pg.owner, plan, np.int32(plan.n_steps),
                    in_rows, in_step, in_valid, np.bool_(seed_fresh))
    store = tc.PartitionStore(tpg, device="cpu")
    entry = store.get(pid)
    tplan = plan_to_device(plan_arrays_from_numpy(**_plan_fields(plan)), "cpu")
    got = port_eval(entry.part, entry.g2l, store.owner, tplan, plan.n_steps,
                    torch.from_numpy(in_rows), torch.from_numpy(in_step),
                    torch.from_numpy(in_valid), seed_fresh)
    # every field the JAX evaluator returns (``landed`` is the port's own)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"pid {pid} {name}")
    return want


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eval_result_matches_reference(both, use_pallas):
    """Every EvalResult field, for every partition of small_pg: a seeding
    call on each partition, then a call fed with the continuations it
    routed to each other partition."""
    g, pg, tg, tpg = both
    cat = ref_catalog(g)
    cfg = dict(cap=CAP, expand_block=16)
    ref_eval = ref_evaluator(pg.node_pad, pg.ell_width,
                             RefConfig(**cfg, use_pallas=use_pallas))
    port_eval = tc.make_partition_evaluator(tpg.node_pad, tpg.ell_width,
                                            tc.EngineConfig(**cfg))
    queries = [q for q, _ in _queries(g, tg)]
    plans = [RefPlanArrays.from_plan(ref_generate_plan(q, g, cat), pad_steps=12)
             for q in (queries[:1] if use_pallas else queries)]
    empty = (np.full((CAP, 8), -1, np.int32), np.zeros(CAP, np.int32),
             np.zeros(CAP, bool))
    for plan in plans:
        for pid in range(pg.k):
            res = _eval_both(ref_eval, port_eval, pg, tpg, pid, plan, *empty, True)
            n = int(res.out_n)
            dest = np.asarray(res.out_dest)[:n]
            for q in sorted(set(dest.tolist())):
                sel = dest == q
                rows, step, valid = (a.copy() for a in empty)
                rows[:sel.sum()] = np.asarray(res.out_rows)[:n][sel]
                step[:sel.sum()] = np.asarray(res.out_step)[:n][sel]
                valid[:sel.sum()] = True
                _eval_both(ref_eval, port_eval, pg, tpg, q, plan, rows, step,
                           valid, False)


def _opat_both(both, heuristic, max_answers=None, cap=16384):
    g, pg, tg, tpg = both
    cat, tcat = ref_catalog(g), tc.build_catalog(tg)
    ref_eng = RefOPAT(pg, RefConfig(cap=cap))
    port_eng = tc.OPATEngine(tpg, tc.EngineConfig(cap=cap), device="cpu")
    for q, tq in _queries(g, tg):
        want = ref_eng.run(ref_generate_plan(q, g, cat), heuristic, seed=1,
                           max_answers=max_answers)
        got = port_eng.run(tc.generate_plan(tq, tg, tcat), heuristic, seed=1,
                           max_answers=max_answers)
        yield q, want, got


@pytest.mark.parametrize("heuristic", HEURISTICS)
def test_opat_matches_reference(both, heuristic):
    g = both[0]
    for q, want, got in _opat_both(both, heuristic):
        np.testing.assert_array_equal(got.answers, want.answers, err_msg=q.name)
        assert got.stats.loads == want.stats.loads, q.name
        assert got.stats.iterations == want.stats.iterations, q.name
        assert np.array_equal(np.unique(got.answers, axis=0),
                              match_query(g, q, q_pad=8)), q.name
        for f in ("cold_loads", "warm_loads", "prefetch_hits", "bytes_cold",
                  "bytes_prefetched"):
            assert getattr(got.stats, f) == getattr(want.stats, f), (q.name, f)


@pytest.mark.parametrize("K", [1, 3])
def test_opat_answer_budget_matches_reference(both, K):
    g = both[0]
    for q, want, got in _opat_both(both, "max-sn", max_answers=K):
        np.testing.assert_array_equal(got.answers, want.answers, err_msg=q.name)
        assert got.stats.loads == want.stats.loads, q.name
        assert got.stats.iterations == want.stats.iterations, q.name
        ref_set = {tuple(r) for r in match_query(g, q, q_pad=8)}
        assert got.answers.shape[0] == min(K, len(ref_set))
        assert all(tuple(r) in ref_set for r in got.answers)


def test_opat_overflow_raises(both):
    """A buffer too small for the partition's rows raises in both packages
    (never a silent truncation)."""
    with pytest.raises(RuntimeError, match="overflow"):
        list(_opat_both(both, "max-sn", cap=2))
    g, _, tg, tpg = both
    tq = subgen_queries(tg)[0].disjuncts[0]
    eng = tc.OPATEngine(tpg, tc.EngineConfig(cap=2), device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        eng.run(tc.generate_plan(tq, tg, tc.build_catalog(tg)), "max-sn")


def test_opat_counts_inner_iterations(both):
    """inner_iters sums EvalResult.n_iters: one fused-step call each."""
    _, _, tg, tpg = both
    calls = []
    eng = tc.OPATEngine(tpg, tc.EngineConfig(cap=16384), device="cpu")
    inner = eng._eval

    def counting(*a):
        res = inner(*a)
        calls.append(int(res.n_iters))
        return res
    eng._eval = counting
    tq = subgen_queries(tg)[0].disjuncts[0]
    eng.run(tc.generate_plan(tq, tg, tc.build_catalog(tg)), "max-sn")
    assert eng.inner_iters == sum(calls) > 0


def test_session_submit_matches_oracle(both):
    g, pg, tg, tpg = both
    sess = tc.GraphSession(pg=tpg, seed=1, config=tc.EngineConfig(cap=16384),
                           device="cpu")
    ref_sess = RefSession(pg=pg, seed=1, config=RefConfig(cap=16384))
    for dq, tdq in zip(ref_subgen_queries(g), subgen_queries(tg)):
        want = match_disjunctive(g, dq, q_pad=8)
        res = sess.submit(tdq)
        np.testing.assert_array_equal(res.answers, want, err_msg=dq.name)
        rres = ref_sess.submit(dq)
        assert res.n_loads == rres.n_loads
        assert res.load_stats.to_dict() == rres.load_stats.to_dict()
        budget = sess.submit(tdq, max_answers=2)
        assert budget.n_answers == min(2, want.shape[0])
        assert {tuple(r) for r in budget.answers} <= {tuple(r) for r in want}
    assert sess.load_stats.warm_loads > 0   # repeated queries hit resident partitions


def test_session_profile_counters_match_reference(both):
    g, pg, tg, tpg = both
    sess = tc.GraphSession(pg=tpg, seed=1, config=tc.EngineConfig(cap=16384),
                           device="cpu")
    ref_sess = RefSession(pg=pg, seed=1, config=RefConfig(cap=16384))
    for dq, tdq in zip(ref_subgen_queries(g), subgen_queries(tg)):
        sess.submit(tdq)
        ref_sess.submit(dq)
    for name in ("_loads", "_completed", "_spawned", "_cospan", "_vertex_span"):
        np.testing.assert_array_equal(getattr(sess, name),
                                      getattr(ref_sess, name), err_msg=name)
    assert (sess._span_sum, sess._span_rows, sess._answers_served) == \
        (ref_sess._span_sum, ref_sess._span_rows, ref_sess._answers_served)


def test_session_rejects_unported_engines_and_devices(both):
    tpg = both[3]
    mr = tc.GraphSession(pg=tpg, engine="mapreduce", heuristic="min-sn", device="cpu")
    assert isinstance(mr.engine, tc.MapReduceMPEngine)
    assert (mr.engine.P, mr.engine.heuristic) == (tpg.k, "min-sn")
    assert mr.engine.store is mr.store and mr.engine.device == mr.device
    sess = tc.GraphSession(pg=tpg, engine="traditional", device="cpu")
    assert isinstance(sess.engine, tc.TraditionalMPEngine) and sess.engine.p == 2
    with pytest.raises(ValueError):
        tc.GraphSession(pg=tpg, engine="nope", device="cpu")
    with pytest.raises(ValueError):
        tc.PartitionStore(tpg, device="meta")


def test_default_device_is_cuda(both):
    """device=None means cuda; with no card the entry points raise instead
    of running on the CPU."""
    tpg = both[3]
    if torch.cuda.is_available():
        assert tc.PartitionStore(tpg).device.type == "cuda"
        return
    for make in (lambda: tc.PartitionStore(tpg),
                 lambda: tc.OPATEngine(tpg),
                 lambda: tc.GraphSession(pg=tpg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_store_counters_match_reference(both):
    """The same sequence of gets, prefetches and pins gives the same
    counters and residency in both stores."""
    _, pg, _, tpg = both
    ref_store = RefStore(pg, capacity_parts=2)
    store = tc.PartitionStore(tpg, capacity_parts=2, device="cpu")

    def ops(s):
        s.get(0)
        s.prefetch(1)
        s.get(1)
        with s.pinned(1):
            s.prefetch(2)
            s.prefetch(3)
            assert 1 in s.resident_keys()
        s.get(3)
        s.get(0)
        return s.stats.to_dict(), sorted(s.resident_keys())
    assert ops(store) == ops(ref_store)


def test_store_capacity_bytes_matches_reference(both):
    _, pg, _, tpg = both
    cap = 2 * RefStore(pg).host_nbytes(0) + 1
    ref_store = RefStore(pg, capacity_bytes=cap)
    store = tc.PartitionStore(tpg, capacity_bytes=cap, device="cpu")
    for s in (ref_store, store):
        for pid in (0, 1, 2, 0, 3):
            s.get(pid)
    assert store.stats.to_dict() == ref_store.stats.to_dict()
    assert sorted(store.resident_keys()) == sorted(ref_store.resident_keys())


# ---------------------------------------------------------------------------
# the lane evaluator against jax.vmap of the JAX evaluator
# ---------------------------------------------------------------------------

def _ref_plans(both, n=None):
    g, _, _, _ = both
    cat = ref_catalog(g)
    qs = [q for q, _ in _queries(g, both[2])]
    return [RefPlanArrays.from_plan(ref_generate_plan(q, g, cat), pad_steps=12)
            for q in qs[:n]]


def _ref_stacked(pg, pids):
    parts = [ref_part_dict(pg.parts[p]) for p in pids]
    return ({k: np.stack([d[k] for d in parts]) for k in parts[0]},
            np.stack([pg.g2l[p] for p in pids]))


def _lane_inputs(L, cap, rows=None):
    """Empty [L, cap] inputs; ``rows`` maps lane -> (rows, step)."""
    in_rows = np.full((L, cap, 8), -1, np.int32)
    in_step = np.zeros((L, cap), np.int32)
    in_valid = np.zeros((L, cap), bool)
    for i, (r, st) in (rows or {}).items():
        n = min(len(r), cap)
        in_rows[i, :n], in_step[i, :n], in_valid[i, :n] = r[:n], st[:n], True
    return in_rows, in_step, in_valid


def _assert_lanes_equal(got, loops, want, what):
    # every field the JAX evaluator returns (``landed`` is the port's own)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=f"{what} {name}")
    # the loop runs while any lane is active: as long as the longest lane
    assert loops == int(np.asarray(want.n_iters).max())


def _routed(res, lane_dest):
    """Continuations each lane emitted, regrouped by destination lane."""
    out = {}
    n = np.asarray(res.out_n)
    for i in range(n.shape[0]):
        rows = np.asarray(res.out_rows)[i, :n[i]]
        step = np.asarray(res.out_step)[i, :n[i]]
        dest = np.asarray(res.out_dest)[i, :n[i]]
        for q, lane in lane_dest.items():
            sel = dest == q
            if sel.any():
                r, st = out.get(lane, (np.zeros((0, 8), np.int32),
                                       np.zeros(0, np.int32)))
                out[lane] = (np.concatenate([r, rows[sel]]),
                             np.concatenate([st, step[sel]]))
    return out


@pytest.mark.parametrize("use_pallas,cap,max_iters",
                         [(False, CAP, 10_000), (True, CAP, 10_000),
                          (False, 1, 10_000), (False, CAP, 2)])
def test_lane_evaluator_matches_vmap_over_partitions(both, use_pallas, cap,
                                                     max_iters):
    """TraditionalMP's form: one plan, one lane per partition of a stacked
    bundle (``traditional_mp.py:56``).  A seeding round, then a round fed
    with the continuations each lane routed to the others.  A small cap
    overflows some lanes only; a small ``max_inner_iters`` freezes lanes
    that are still active."""
    g, pg, tg, tpg = both
    cfg = dict(cap=cap, expand_block=16, max_inner_iters=max_iters)
    ref_eval = ref_evaluator(pg.node_pad, pg.ell_width,
                             RefConfig(**cfg, use_pallas=use_pallas))
    veval = jax.jit(jax.vmap(ref_eval, in_axes=(0, 0, None, None, None,
                                                0, 0, 0, 0)))
    lanes = tc.make_batched_evaluator(tc.EngineConfig(**cfg))
    pids = (0, 1, 2, 3)
    part, g2l = _ref_stacked(pg, pids)
    entry = tc.PartitionStore(tpg, device="cpu").get_stacked(pids)
    owner = torch.from_numpy(tpg.owner)
    overflow, n_iters = [], []
    for plan in _ref_plans(both, 2 if (cap, max_iters) == (CAP, 10_000)
                           and not use_pallas else 1):
        tplans = plan_to_device(tc.PlanArrays.stack(
            [plan_arrays_from_numpy(**_plan_fields(plan))]), "cpu")
        seeds = np.array([True, True, False, True])
        inputs = _lane_inputs(4, cap)
        for rnd in range(2):
            want = veval(part, g2l, pg.owner, plan, np.int32(plan.n_steps),
                         *inputs, seeds)
            got, loops = lanes(entry.part, entry.g2l, owner, tplans,
                               [plan.n_steps], range(4), [0] * 4,
                               *(torch.from_numpy(a) for a in inputs),
                               torch.from_numpy(seeds))
            _assert_lanes_equal(got, loops, want, f"round {rnd}")
            overflow += np.asarray(want.overflow).tolist()
            n_iters += np.asarray(want.n_iters).tolist()
            inputs = _lane_inputs(4, cap, _routed(want, {p: p for p in pids}))
            seeds = ~seeds
    if cap < CAP:
        assert any(overflow) and not all(overflow)
    if max_iters < 10_000:
        assert max_iters in n_iters
        assert any(0 < n < max_iters for n in n_iters)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_lane_evaluator_matches_vmap_over_queries(both, use_pallas):
    """OPAT's ``batched_evaluator()`` (``opat.py:103-117``): one partition,
    one lane per stacked plan, seeding round then continuations routed to
    the partition."""
    g, pg, tg, tpg = both
    cfg = dict(cap=CAP, expand_block=16)
    beval = RefOPAT(pg, RefConfig(**cfg, use_pallas=use_pallas)).batched_evaluator()
    store = tc.PartitionStore(tpg, device="cpu")
    eng = tc.OPATEngine(tpg, tc.EngineConfig(**cfg), store=store)
    port = eng.batched_evaluator()
    plans = _ref_plans(both)
    if use_pallas:
        plans = plans[:2]
    B = len(plans) + 1                      # a repeated plan rides too
    plans = plans + plans[:1]
    stacked = RefPlanArrays.stack(plans)
    tplans = plan_to_device(tc.PlanArrays.stack(
        [plan_arrays_from_numpy(**_plan_fields(p)) for p in plans]), "cpu")
    n_steps = np.array([p.n_steps for p in plans], np.int32)
    seeds = np.array([True] * (B - 1) + [False])
    continuations = {}
    for pid in (1, 0):
        inputs = _lane_inputs(B, CAP, continuations)
        want = beval(ref_part_dict(pg.parts[pid]), pg.g2l[pid], pg.owner,
                     stacked, n_steps, *inputs, seeds)
        entry = store.get(pid)
        loops0 = eng.batched_iters
        got = port(entry.part, entry.g2l, store.owner, tplans,
                   torch.from_numpy(n_steps),
                   *(torch.from_numpy(a) for a in inputs), seeds.tolist())
        _assert_lanes_equal(got, eng.batched_iters - loops0, want, f"pid {pid}")
        # lane b's rows bound for partition 0 feed lane b's next call
        continuations = {}
        for b in range(B):
            n = int(np.asarray(want.out_n)[b])
            sel = np.asarray(want.out_dest)[b, :n] == 0
            continuations[b] = (np.asarray(want.out_rows)[b, :n][sel],
                                np.asarray(want.out_step)[b, :n][sel])
        seeds = np.ones(B, bool)


def test_lane_evaluator_tallies_its_appends(both):
    """The lane evaluator leaves each lane's landed rows on the device
    (``EvalResult.landed``); ``lane_outputs`` sums them in the same read as
    the counts, and ``ranked_slots`` counts the slots the loops ranked.
    Every completed and outgoing row landed once, the rest were kept, and
    each kept row was expanded by a later loop."""
    g, pg, tg, tpg = both
    lanes = tc.make_batched_evaluator(tc.EngineConfig(cap=CAP, expand_block=16))
    entry = tc.PartitionStore(tpg, device="cpu").get_stacked((0, 1, 2, 3))
    plan = _ref_plans(both, 1)[0]
    tplans = plan_to_device(tc.PlanArrays.stack(
        [plan_arrays_from_numpy(**_plan_fields(plan))]), "cpu")
    got, loops = lanes(entry.part, entry.g2l, torch.from_numpy(tpg.owner), tplans,
                       [plan.n_steps], range(4), [0] * 4,
                       *(torch.from_numpy(a) for a in _lane_inputs(4, CAP)),
                       torch.ones(4, dtype=torch.bool))
    W = entry.part["ell_dst"].shape[2]
    assert ranked_slots(tc.EngineConfig(cap=CAP, expand_block=16), entry.part,
                        4, loops) == 4 * loops * 16 * W
    outs, landed = lane_outputs(got)
    assert len(outs) == 4 and landed == int(got.landed.sum())
    assert not bool(got.overflow.any())
    kept = got.landed - got.comp_n.long() - got.out_n.long()
    assert bool((kept >= 0).all()) and int(kept.sum()) > 0
    assert bool((kept <= got.n_expanded.long()).all())


# ---------------------------------------------------------------------------
# TraditionalMP
# ---------------------------------------------------------------------------

_REF_TMP = {}


def _ref_tmp(pg, p, cap):
    """One JAX engine per (p, cap) for the whole module, so its jit cache
    (one trace per plan shape) is reused; each use gets a fresh store."""
    eng = _REF_TMP.get((p, cap))
    if eng is None or eng.pg is not pg:
        eng = _REF_TMP[(p, cap)] = RefTMP(pg, p, RefConfig(cap=cap))
    eng.store = RefStore(pg)
    return eng


def _tmp_both(both, p, heuristics, queries, max_answers=None, cap=CAP):
    g, pg, tg, tpg = both
    cat, tcat = ref_catalog(g), tc.build_catalog(tg)
    ref_eng = _ref_tmp(pg, p, cap)
    port_eng = tc.TraditionalMPEngine(tpg, p, tc.EngineConfig(cap=cap),
                                      device="cpu")
    for h in heuristics:
        for q, tq in [_queries(g, tg)[i] for i in queries]:
            want = ref_eng.run(ref_generate_plan(q, g, cat), h, seed=1,
                               max_answers=max_answers)
            got = port_eng.run(tc.generate_plan(tq, tg, tcat), h, seed=1,
                               max_answers=max_answers)
            yield q, want, got


def _assert_tmp_equal(q, want, got):
    np.testing.assert_array_equal(got.answers, want.answers, err_msg=q.name)
    assert got.stats.loads == want.stats.loads, q.name
    assert got.stats.iterations == want.stats.iterations, q.name
    assert got.partitions_per_iteration == want.partitions_per_iteration, q.name
    for f in ("cold_loads", "warm_loads", "bytes_cold", "n_answers"):
        assert getattr(got.stats, f) == getattr(want.stats, f), (q.name, f)


@pytest.mark.parametrize("p", [1, 2, 4, 6])
def test_traditional_matches_reference(both, p):
    """Answers, loads, iterations, partitions_per_iteration and store
    counters for MAX-SN, MIN-SN and MAX-YIELD (Q4 and Q6; Q5 at p=2)."""
    g = both[0]
    queries = (0, 1, 2) if p == 2 else (0, 2)
    for q, want, got in _tmp_both(both, p, ("max-sn", "min-sn", "max-yield"),
                                  queries):
        _assert_tmp_equal(q, want, got)
        assert np.array_equal(got.answers, match_query(g, q, q_pad=8)), q.name


@pytest.mark.parametrize("K", [0, 1, 3])
def test_traditional_answer_budget_matches_reference(both, K):
    for q, want, got in _tmp_both(both, 2, ("max-sn",), (0, 1), max_answers=K):
        _assert_tmp_equal(q, want, got)
        assert got.answers.shape[0] <= K
    if K == 0:
        assert got.stats.loads == []


def test_traditional_overflow_raises(both):
    with pytest.raises(RuntimeError, match="overflow"):
        list(_tmp_both(both, 2, ("max-sn",), (0,), cap=1))
    g, _, tg, tpg = both
    tq = subgen_queries(tg)[0].disjuncts[0]
    eng = tc.TraditionalMPEngine(tpg, 2, tc.EngineConfig(cap=1), device="cpu")
    with pytest.raises(RuntimeError, match="overflow"):
        eng.run(tc.generate_plan(tq, tg, tc.build_catalog(tg)), "max-sn")


def test_traditional_counts_one_launch_per_loop(both):
    """Each lane-evaluator call adds its loop count to batched_iters: one
    fused-step call per loop iteration, however many lanes."""
    from repro_torch.kernels import ops as kops
    _, _, tg, tpg = both
    eng = tc.TraditionalMPEngine(tpg, 4, tc.EngineConfig(cap=CAP), device="cpu")
    calls = []
    inner = kops.frontier_step

    def counting(inv, wr, ws, lidx, sel, m, out):
        calls.append(sel.numel())          # rows of all lanes in one launch
        return inner(inv, wr, ws, lidx, sel, m, out)
    kops.frontier_step = counting
    try:
        tq = subgen_queries(tg)[1].disjuncts[0]
        eng.run(tc.generate_plan(tq, tg, tc.build_catalog(tg)), "max-sn")
    finally:
        kops.frontier_step = inner
    assert eng.batched_iters == len(calls) > 0
    assert max(calls) > 16 * 1      # some launch carried several lanes' rows


# ---------------------------------------------------------------------------
# the stacked store and the SNI seed
# ---------------------------------------------------------------------------

def test_store_stacked_counters_match_reference(both):
    """get_stacked keys are order-sensitive and keep padding duplicates; a
    bundle costs its length against capacity_parts; at most
    max_stacked_entries bundles stay; release counts, drop does not."""
    _, pg, _, tpg = both

    def ops(s):
        s.get_stacked((0, 1))
        s.get_stacked((0, 1))
        s.get_stacked((1, 0))
        s.get_stacked((2, 2))
        s.get(3)
        with s.pinned((0, 1)):
            s.get_stacked((0, 1, 2))
            keys = sorted(map(str, s.resident_keys()))
        s.get_stacked((3,))
        released = (s.release((2, 2)), s.release(3), s.release(0))
        dropped = s.drop((3,))
        return s.stats.to_dict(), keys, released, dropped, \
            sorted(map(str, s.resident_keys()))

    for kw in (dict(capacity_parts=5), dict(max_stacked_entries=2), {}):
        got = ops(tc.PartitionStore(tpg, device="cpu", **kw))
        assert got == ops(RefStore(pg, **kw)), kw
    with pytest.raises(ValueError):
        tc.PartitionStore(tpg, device="cpu").get_stacked(())
    with pytest.raises(ValueError):
        tc.PartitionStore(tpg, device="cpu", max_stacked_entries=0)


def test_stacked_entry_holds_the_partitions_in_order(both):
    _, pg, _, tpg = both
    entry = tc.PartitionStore(tpg, device="cpu").get_stacked((2, 0, 2))
    for i, pid in enumerate((2, 0, 2)):
        want = tc.engine.part_to_device_dict(tpg.parts[pid])
        for k, v in want.items():
            np.testing.assert_array_equal(entry.part[k][i].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(entry.g2l[i].numpy(), tpg.g2l[pid])
    assert entry.cost_parts == 3


def test_label_histogram_gives_the_sni_seed(both):
    """ops.label_histogram over each partition's core nodes equals the
    host's start_label_counts, for every subgen start predicate and a
    wildcard one."""
    from repro_torch.kernels import ops as kops
    g, _, tg, tpg = both
    cat = tc.build_catalog(tg)
    preds = [(-1, 0, 0.0)]
    for _, tq in _queries(g, tg):
        plan = tc.generate_plan(tq, tg, cat)
        preds.append((plan.start_label, plan.start_value_op, plan.start_value))
    for label, op, value in preds:
        want = tpg.start_label_counts(label, op, value)
        for p in tpg.parts:
            core = (np.arange(tpg.node_pad) < p.n_core).astype(np.int32)
            got = kops.label_histogram(torch.from_numpy(p.node_label),
                                       torch.from_numpy(p.node_value),
                                       torch.from_numpy(core), label, op, value)
            assert int(got) == want[p.pid], (label, op, p.pid)


def _string_prefix(node) -> str:
    """The literal text a string expression starts with ('' if none)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        out = ""
        for part in node.values:
            if not (isinstance(part, ast.Constant) and isinstance(part.value, str)):
                break
            out += part.value
        return out
    return ""


def _is_import_call(func) -> bool:
    """``importlib.import_module``, ``import_module`` or ``__import__``."""
    name = func.attr if isinstance(func, ast.Attribute) else getattr(func, "id", "")
    return name in ("import_module", "__import__")


def _imports(path):
    """Every module a file imports: import statements and the literal
    start of a string passed to ``importlib.import_module`` / ``__import__``
    (a relative name starts with '.')."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and _is_import_call(node.func) and node.args:
            yield _string_prefix(node.args[0])


def test_port_imports_neither_jax_nor_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files += sorted((REPO / "examples").glob("torch_*.py"))
    assert len(files) > 20
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"src/repro_torch/core/mapreduce_mp.py",
            "src/repro_torch/launch/serve.py",
            "src/repro_torch/core/repartition.py",
            "src/repro_torch/storage/__init__.py",
            "src/repro_torch/storage/format.py",
            "src/repro_torch/storage/host_cache.py",
            "src/repro_torch/obs/metrics.py",
            "src/repro_torch/obs/profile.py",
            "src/repro_torch/serving/__init__.py",
            "src/repro_torch/serving/cost.py",
            "src/repro_torch/serving/frontend.py",
            "src/repro_torch/storage/deltas.py",
            "src/repro_torch/models/config.py",
            "src/repro_torch/models/layers.py",
            "src/repro_torch/models/transformer.py",
            "src/repro_torch/models/xlstm.py",
            "src/repro_torch/models/rglru.py",
            "src/repro_torch/configs/registry.py",
            "src/repro_torch/configs/qwen2_1_5b.py",
            "src/repro_torch/serving/decode.py",
            "src/repro_torch/data/tokens.py",
            "src/repro_torch/train/__init__.py",
            "src/repro_torch/train/optimizer.py",
            "src/repro_torch/train/step.py",
            "src/repro_torch/distributed/__init__.py",
            "src/repro_torch/distributed/checkpoint.py",
            "src/repro_torch/distributed/watchdog.py",
            "src/repro_torch/launch/train.py",
            "src/repro_torch/launch/op_cost.py",
            "src/repro_torch/launch/cost_analysis.py",
            "src/repro_torch/launch/dryrun.py",
            "src/repro_torch/launch/mesh.py",
            "src/repro_torch/launch/sharding.py",
            "src/repro_torch/distributed/comm.py",
            "src/repro_torch/distributed/fsdp.py",
            "examples/torch_quickstart.py",
            "examples/torch_serve_queries.py",
            "examples/torch_mapreduce_demo.py",
            "examples/torch_train_lm.py"} <= names
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: imports {mod}"


@pytest.mark.parametrize("src, found", [
    ('import importlib\nimportlib.import_module("repro.configs.qwen2_1_5b")', "repro.configs.qwen2_1_5b"),
    ('import importlib\nmid = "x"\nimportlib.import_module(f"repro.configs.{mid}")', "repro.configs."),
    ('from importlib import import_module\nimport_module("jax.numpy")', "jax.numpy"),
    ('__import__("jaxlib")', "jaxlib"),
    ('import importlib\nimportlib.import_module(f".{__name__}", __package__)', "."),
], ids=["constant", "f-string", "bare", "dunder", "relative"])
def test_import_check_reads_string_imports(tmp_path, src, found):
    """The import check sees a module named by string (the configs
    registry loads its modules that way), and a relative name passes."""
    f = tmp_path / "m.py"
    f.write_text(src + "\n")
    mods = list(_imports(f))
    assert found in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bool(bad) == (found != ".")
