"""The port's spans inside the front end and the scheduler, the evaluator's
loop counters on ``kernel.eval``, and the clock anchors, on the CPU.

A traced ``ServingFrontend.serve`` gives the span tree the benchmark's
host-read metrics read (``graphbench/metrics``), and the tree passes
``tools/trace_report.py``'s nesting check; each ``kernel.eval`` carries
its call's step launches and lanes; tracing changes no answer; an
untraced session hands the null tracer no attribute to build; and a
clock anchor's two reads bracket the clocks read around it.
"""
import importlib.util
import math
import pathlib
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc
from repro_torch import serving
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.data.generators import subgen_queries
from repro_torch.obs import NULL_TRACER, Tracer, to_chrome_trace
from repro_torch.obs.trace import NullTracer

ROOT = pathlib.Path(__file__).resolve().parent.parent

CAP = 1024
ENGINES = ["opat", "traditional"]
PATHS = ["slo", "plain"]
# the spans a traced serve gives, each with its parent and attributes
TREE = {
    "frontend.serve": (None, {"requests", "rounds"}),
    "frontend.admit": ("frontend.serve", set()),
    "scheduler.admit": ("frontend.admit", {"qid", "disjuncts"}),
    "scheduler.run": ("frontend.serve", {"max_rounds", "results"}),
    "scheduler.retire": ("scheduler.run", {"retired"}),
    "scheduler.rank": ("scheduler.run", {"candidates"}),
    "scheduler.round": ("scheduler.run", {"round", "batch", "qids", "tier", "nbytes"}),
    "kernel.eval": ("scheduler.round", {"batch", "lanes", "loops"}),
    "scheduler.absorb": (("scheduler.round", "scheduler.run"), {"lanes"}),
    "scheduler.collect": ("scheduler.run", {"results"}),
    "frontend.drain": ("frontend.serve", {"results"}),
    "session.absorb": ("frontend.drain", {"answers"}),
    "clock.anchor": ("frontend.serve", {"wall_ns", "perf_ns"}),
}
# the plain path is submit_many: no admission verdicts, no drain
PLAIN = {"frontend.admit": None, "scheduler.admit": "frontend.serve",
         "frontend.drain": None, "session.absorb": "frontend.serve"}


def _trace_report():
    spec = importlib.util.spec_from_file_location("trace_report",
                                                  ROOT / "tools" / "trace_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes at once).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(small_graph, small_pg):
    """The port's graph, partitions and the path queries."""
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
    return tpg, subgen_queries(tg)


def _serve(port, engine, path, tracer=None):
    """Six requests (two of them budgeted) through a front end: one
    infinite-deadline class as the benchmark serves them, or no class
    (``submit_many``).  Returns the session, the report, and the
    evaluator's loop count of every call."""
    tpg, queries = port
    sess = tc.GraphSession(pg=tpg, engine=engine, seed=1, processors=2,
                           config=tc.EngineConfig(cap=CAP), device="cpu",
                           tracer=tracer)
    calls = []
    eng = sess.engine
    name = "batched_evaluator" if engine == "opat" else "shared_evaluator"
    real = getattr(eng, name)

    def counted():
        fn = real()

        def call(*args):
            n0 = eng.batched_iters
            out = fn(*args)
            calls.append(eng.batched_iters - n0)
            return out
        return call
    setattr(eng, name, counted)
    budgets = [None, 5, None, None, 3, None]
    cls = "all" if path == "slo" else None
    reqs = [serving.Request(q, slo_class=cls, max_answers=k)
            for q, k in zip(queries * 2, budgets)]
    classes = [serving.SLOClass("all", deadline_s=math.inf, priority=0)] \
        if path == "slo" else []
    fe = sess.frontend(slo_classes=classes, shed_policy="never")
    return sess, fe.serve(reqs), calls


@pytest.fixture(scope="module")
def traced(port):
    return {(e, p): _serve(port, e, p, Tracer()) for e in ENGINES for p in PATHS}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("engine", ENGINES)
def test_serve_span_tree(traced, engine, path):
    """Every span of the table nests under its caller with its attributes,
    the shared ranking's decisions sit under ``scheduler.rank`` and the
    admission verdicts under ``frontend.admit``, and the trace passes
    ``trace_report --check``."""
    sess, rep, _ = traced[engine, path]
    tr = sess.tracer
    by_id = {sp.span_id: sp for sp in tr.spans}
    # the anchor a tracer takes when it is built has no parent
    spans = [sp for sp in tr.spans if sp.name in TREE
             and not (sp.name == "clock.anchor" and sp.parent_id is None)]
    names = {sp.name for sp in spans}
    want = {n for n in TREE if not (path == "plain" and n in PLAIN and PLAIN[n] is None)}
    assert want <= names, want - names
    for sp in spans:
        parent, attrs = TREE[sp.name]
        if path == "plain":
            parent = PLAIN.get(sp.name, parent)
        got = by_id[sp.parent_id].name if sp.parent_id is not None else None
        assert got in (parent if isinstance(parent, tuple) else (parent,)), sp.name
        assert attrs <= set(sp.attrs), (sp.name, sp.attrs)
        if sp.parent_id is not None:
            up = by_id[sp.parent_id]
            assert up.t0 <= sp.t0 and sp.t1 <= up.t1, sp.name
    serve = [sp for sp in spans if sp.name == "frontend.serve"]
    assert len(serve) == 1 and serve[0].attrs["requests"] == 6
    assert serve[0].attrs["rounds"] == rep.rounds
    assert sum(sp.attrs["results"] for sp in spans if sp.name == "scheduler.collect") == 6
    ranks = [d for d in tr.decisions if d["kind"] == "heuristic.rank_shared"]
    assert ranks and all(by_id[d["span_id"]].name == "scheduler.rank" for d in ranks)
    # each verdict's decision record, with its query and outcome, sits
    # inside the admission span that reached it
    verdicts = [d for d in tr.decisions if d["kind"] == "frontend.admit"]
    assert len(verdicts) == (6 if path == "slo" else 0)
    assert all(by_id[d["span_id"]].name == "frontend.admit"
               and d["outcome"] == "admit" and d["query"] for d in verdicts)
    report = _trace_report()
    events = to_chrome_trace(tr)["traceEvents"]
    trace = {"spans": [e for e in events if e.get("ph") == "X"],
             "decisions": [e for e in events if e.get("ph") == "i"
                           and e.get("cat") == "decision"]}
    assert report.check(trace) == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_kernel_eval_loops_and_lanes(traced, engine):
    """Each ``kernel.eval``'s ``loops`` is its call's ``batched_iters``
    delta, in order, and its ``lanes`` the call's lanes: the batch on
    OPAT, the (job, partition) pairs that carry work on TraditionalMP."""
    sess, _, calls = traced[engine, "slo"]
    evals = [sp for sp in sess.tracer.spans if sp.name == "kernel.eval"]
    assert [sp.attrs["loops"] for sp in evals] == calls and sum(calls) > 0
    for sp in evals:
        if engine == "opat":
            assert sp.attrs["lanes"] == sp.attrs["batch"] >= 1
        else:
            assert sp.attrs["batch"] <= sp.attrs["lanes"] <= sp.attrs["batch"] * 2
    rounds = [sp for sp in sess.tracer.spans if sp.name == "scheduler.round"]
    assert len(evals) >= len(rounds)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("engine", ENGINES)
def test_traced_answers_equal_untraced(port, traced, engine, path):
    _, want, _ = _serve(port, engine, path)
    _, got, _ = traced[engine, path]
    assert [o.status for o in got.outcomes] == [o.status for o in want.outcomes]
    for a, b in zip(got.outcomes, want.outcomes):
        np.testing.assert_array_equal(a.result.answers, b.result.answers)
    assert got.schedule is None or got.schedule.loads == want.schedule.loads


def test_untraced_serve_builds_no_attributes(port, monkeypatch):
    """With the null tracer the front end, the scheduler and the session
    pass no attribute to any span they open, and take no anchor."""
    opened = []
    real = NullTracer.span

    def span(self, name, **attrs):
        opened.append((name, attrs))
        return real(self, name, **attrs)
    monkeypatch.setattr(NullTracer, "span", span)
    monkeypatch.setattr(NullTracer, "anchor", lambda self: opened.append(("anchor", {})))
    for engine in ENGINES:
        sess, _, _ = _serve(port, engine, "slo")
        assert sess.tracer is NULL_TRACER
    ours = [(n, a) for n, a in opened
            if n.split(".")[0] in ("frontend", "scheduler", "session", "kernel", "anchor")]
    assert {n for n, _ in ours} >= {"frontend.serve", "scheduler.round", "kernel.eval",
                                    "scheduler.absorb", "session.absorb", "anchor"}
    assert all(not a for _, a in ours)


def test_tracer_anchor_brackets_both_clocks():
    """A tracer's first record is a ``clock.anchor`` whose two reads agree
    with the clocks read around it; ``anchor()`` appends another, under
    the open span."""
    w0, p0 = time.time_ns(), time.perf_counter_ns()
    tr = Tracer()
    w1, p1 = time.time_ns(), time.perf_counter_ns()
    (a,) = tr.spans
    assert a.name == "clock.anchor" and a.t0 == a.t1
    assert p0 <= a.attrs["perf_ns"] <= p1 and w0 <= a.attrs["wall_ns"] <= w1
    with tr.span("frontend.serve") as sp:
        tr.anchor()
    b = tr.spans[1]
    assert b.name == "clock.anchor" and b.parent_id == sp.span_id
    assert b.attrs["perf_ns"] > a.attrs["perf_ns"]
    assert NULL_TRACER.anchor() is None
