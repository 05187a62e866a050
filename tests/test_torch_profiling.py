"""The PyTorch port's resource profiler (``repro_torch.obs.profile``)
against the JAX package's, on the CPU.

Both packages serve the same graph, partitions and queries (carried over
with ``repro_torch.convert``), each engine once per package with a
``Tracer`` attached (so profiling is on), and the port's once more
without one.  Profiling must change no answer, load or iteration; the
port's ``kernel.eval`` spans must carry the reference's kernel keys, each
with its predicted cost, its step launches and the store's live bytes;
``peak_device_bytes`` must equal the reference's.  The cost itself is the
hand-written step kernel's (``kernels.ops.step_cost``), not the
reference's HLO estimate, so only its shape is compared: it must bound
what one launch's data needs (``kernels.ops.step_bytes_ops``).
MapReduceMP needs one device per partition in the reference, so it runs
at k=1 here.
"""
import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import EngineConfig as RefConfig, GraphSession as RefSession
from repro.core import build_partitions as ref_build_partitions
from repro.data.generators import subgen_queries as ref_subgen_queries
from repro.obs import Tracer as RefTracer
from repro.obs import resource_profile_snapshot as ref_profile_snapshot

import repro_torch.core as tc
from repro_torch.convert import graph_from_arrays, partitioned_graph_from_arrays
from repro_torch.data.generators import subgen_queries
from repro_torch.kernels import ops
from repro_torch.obs import (NULL_PROFILER, NULL_TRACER, ResourceProfiler, Tracer,
                             resource_profile_snapshot, write_chrome_trace)
from repro_torch.obs import profile

ROOT = pathlib.Path(__file__).resolve().parent.parent
CAP = 1024
ENGINES = ["opat", "traditional", "mapreduce"]
COST_ATTRS = ("kernel_key", "cost_flops", "cost_bytes", "cost_t_bound_us",
              "cost_dominant", "launches", "device_live_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors (the suite
    runs several test processes at once).  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_graph(g):
    def vocab(v):
        return [v.str_of(i) for i in range(len(v))]
    return graph_from_arrays(node_label=g.node_label, node_value=g.node_value,
                             edge_src=g.edge_src, edge_dst=g.edge_dst,
                             edge_label=g.edge_label,
                             edge_directed=g.edge_directed,
                             node_vocab=vocab(g.node_vocab),
                             edge_vocab=vocab(g.edge_vocab))


def _serve(sess, queries):
    """Each query, Q4 again under a budget of 5, then all of them through
    ``submit_many``: (answers, loads, iterations) of every result."""
    out = []
    runs = [(q, None) for q in queries] + [(queries[0], 5)]
    for q, k in runs:
        r = sess.submit(q, max_answers=k)
        out.append((r.answers, [s.loads for s in r.stats],
                    [s.iterations for s in r.stats]))
    rep = sess.submit_many(queries)
    for r in rep.results:
        out.append((r.answers, [s.loads for s in r.stats],
                    [s.iterations for s in r.stats]))
    return out


@pytest.fixture(scope="module")
def runs(small_graph, small_pg):
    """Per engine: the reference's profiled session, the port's profiled
    and unprofiled sessions, and what each served, on the same run."""
    g = small_graph
    tg = _port_graph(g)
    dqs, tdqs = ref_subgen_queries(g), subgen_queries(tg)
    out = {}
    for engine in ENGINES:
        if engine == "mapreduce":
            assign = np.zeros(g.n_nodes, dtype=np.int32)
            pg = ref_build_partitions(g, assign, 1, scheme="kway_shem")
        else:
            pg = small_pg
        tpg = partitioned_graph_from_arrays(tg, pg.assignment, pg.k, pg.scheme)
        ref = RefSession(pg=pg, engine=engine, seed=1, processors=2,
                         config=RefConfig(cap=CAP), tracer=RefTracer())
        prof, plain = (tc.GraphSession(pg=tpg, engine=engine, seed=1, processors=2,
                                       config=tc.EngineConfig(cap=CAP), device="cpu",
                                       tracer=tracer)
                       for tracer in (Tracer(), None))
        out[engine] = dict(ref=ref, prof=prof, plain=plain,
                           served={"ref": _serve(ref, dqs),
                                   "prof": _serve(prof, tdqs),
                                   "plain": _serve(plain, tdqs)})
    return out


def _kernel_spans(sess):
    return [s for s in sess.tracer.spans if s.name == "kernel.eval"]


# ---------------------------------------------------------------------------
# the disabled path
# ---------------------------------------------------------------------------

def test_null_profiler_is_noop_singleton():
    assert not NULL_PROFILER.enabled
    assert profile.NULL_PROFILER is NULL_PROFILER
    NULL_PROFILER.sample_device(NULL_TRACER.span("x"), object())
    NULL_PROFILER.attribute_kernel(("a", "b"), 1, 2, 3)
    NULL_PROFILER.stamp_kernel(NULL_TRACER.span("x"), ("a", "b"), 4)
    assert NULL_PROFILER.observe_rss() == 0
    assert NULL_PROFILER.snapshot() == {"enabled": False}
    assert not hasattr(NULL_PROFILER, "__dict__")


def test_session_profiler_defaults(runs):
    """No tracer -> profiling off; a real tracer -> on; an explicit
    profiler always wins, and the store and engine hold the session's."""
    sess = runs["opat"]["prof"]
    assert runs["opat"]["plain"].profiler is NULL_PROFILER
    assert sess.profiler.enabled
    assert sess.store.profiler is sess.profiler is sess.engine.profiler
    mine = ResourceProfiler()
    other = tc.GraphSession(pg=sess.pg, config=sess.config, device="cpu",
                            tracer=Tracer(), profiler=mine)
    assert other.profiler is mine and other.store.profiler is mine
    off = tc.GraphSession(pg=sess.pg, device="cpu", tracer=Tracer(),
                          profiler=NULL_PROFILER)
    assert off.profiler is NULL_PROFILER


def test_disabled_profiler_overhead_under_5pct(runs):
    """The null-path cost of every profiler call a profiled submit_many
    batch makes stays under 5 % of the batch's wall time."""
    sess = runs["opat"]["prof"]
    queries = subgen_queries(sess.graph)
    n0 = len(sess.tracer.spans)
    t0 = time.perf_counter()
    sess.submit_many(queries)
    wall = time.perf_counter() - t0
    # at most two profiler calls per recorded span (sample + stamp)
    n_calls = 2 * (len(sess.tracer.spans) - n0)
    store = sess.store
    reps = 20000
    t0 = time.perf_counter()
    for _ in range(reps):
        NULL_PROFILER.sample_device(NULL_TRACER.span("kernel.eval"), store)
        NULL_PROFILER.stamp_kernel(NULL_TRACER.span("kernel.eval"), ("opat", "eval"), 1)
    per_call = (time.perf_counter() - t0) / (2 * reps)
    assert n_calls * per_call < 0.05 * wall, (n_calls, per_call, wall)


# ---------------------------------------------------------------------------
# profiling on or off, and against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_profiled_unprofiled_parity(runs, engine):
    """Answers, loads and iterations of every submit and of submit_many
    equal with profiling on and off, and equal the reference's."""
    served = runs[engine]["served"]
    for got, plain, want in zip(served["prof"], served["plain"], served["ref"]):
        for other in (plain, want):
            np.testing.assert_array_equal(got[0], other[0])
            assert got[1:] == other[1:]
    assert runs[engine]["prof"].profiler.kernel_costs


@pytest.mark.parametrize("engine", ENGINES)
def test_kernel_keys_match_reference(runs, engine):
    """The same kernel keys as the reference on the same run, and every
    kernel.eval span costed: key, cost, launches and live bytes, no
    ``cost_error``."""
    ref, sess = runs[engine]["ref"], runs[engine]["prof"]
    assert set(sess.profiler.kernel_costs) == set(ref.profiler.kernel_costs)
    assert {s.attrs["kernel_key"] for s in _kernel_spans(sess)} == \
        {s.attrs["kernel_key"] for s in _kernel_spans(ref)}
    spans = _kernel_spans(sess)
    assert spans
    for sp in spans:
        missing = [a for a in COST_ATTRS if a not in sp.attrs]
        assert not missing, (sp.attrs, missing)
        assert "cost_error" not in sp.attrs
    for key, cost in sess.profiler.kernel_costs.items():
        assert "cost_error" not in cost, (key, cost)
        assert cost["flops"] > 0 and cost["bytes"] > 0 and cost["t_bound_us"] > 0
        assert cost["dominant"] in ("memory", "compute")
    # a key's first call is marked, as in the reference
    assert sum(bool(s.attrs.get("first_call")) for s in spans) >= len(sess.profiler.kernel_costs)


@pytest.mark.parametrize("engine", ENGINES)
def test_peak_device_bytes_match_reference(runs, engine):
    """The session peak of the store's live entry bytes equals the
    reference profiler's, and is the largest value stamped on a span."""
    ref, sess = runs[engine]["ref"], runs[engine]["prof"]
    assert sess.profiler.peak_device_bytes == ref.profiler.peak_device_bytes > 0
    live = [s.attrs["device_live_bytes"] for s in sess.tracer.spans
            if "device_live_bytes" in s.attrs]
    assert max(live) == sess.profiler.peak_device_bytes
    got, want = resource_profile_snapshot(sess), ref_profile_snapshot(ref)
    assert set(got) == set(want)
    assert got["bytes"] == want["bytes"]


@pytest.mark.parametrize("engine", ENGINES)
def test_span_cost_is_step_cost_times_launches(runs, engine):
    """Each span's launches sum to the engine's evaluator loops (one step
    launch each), and its cost is one launch's cost times its launches."""
    sess = runs[engine]["prof"]
    spans = _kernel_spans(sess)
    eng = sess.engine
    loops = getattr(eng, "inner_iters", 0) + eng.batched_iters
    assert sum(s.attrs["launches"] for s in spans) == loops > 0
    for sp in spans:
        c = sess.profiler.kernel_costs[sp.attrs["kernel_key"]]
        n = sp.attrs["launches"]
        assert sp.attrs["cost_bytes"] == c["bytes"] * n
        assert sp.attrs["cost_flops"] == c["flops"] * n
        assert sp.attrs["cost_t_bound_us"] == pytest.approx(c["t_bound_us"] * n)
        shape = c["shape"]
        assert (c["flops"], c["bytes"]) == ops.step_cost(*shape.values())
        assert shape["Q"] == sess.config.q_pad and shape["node_pad"] == sess.pg.node_pad


@pytest.mark.parametrize("engine", ENGINES)
def test_trace_report_accepts_port_trace(runs, engine, tmp_path):
    """``tools/trace_report.py --check`` exits 0 on the port's trace, and
    ``--cost`` lists every kernel key."""
    sess = runs[engine]["prof"]
    path = tmp_path / "trace.json"
    write_chrome_trace(sess.tracer, str(path))
    tool = [sys.executable, str(ROOT / "tools" / "trace_report.py"), str(path)]
    check = subprocess.run(tool + ["--check"], capture_output=True, text=True)
    assert check.returncode == 0, check.stderr
    cost = subprocess.run(tool + ["--cost"], capture_output=True, text=True, check=True)
    for key in sess.profiler.kernel_costs:
        assert key in cost.stdout
    assert "attribution failed" not in cost.stdout
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("args", {}).get("kernel_key") for e in events)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

def test_attribution_failure_degrades_not_raises():
    prof = ResourceProfiler()
    cost = prof.attribute_kernel(("broken", "fn"), 1, 0, 20, 8, 12, 64, 100)
    assert cost["cost_error"] == "ValueError"
    assert cost["flops"] == 0.0 and cost["t_bound_us"] == 0.0
    # memoized: the failure is computed once, stamped consistently
    assert prof.attribute_kernel(("broken", "fn"), 1, 512, 20, 8, 12, 64, 100) is cost
    assert prof.attribute_kernel(("short", "shape"), 1, 2)["cost_error"] == "TypeError"
    tr = Tracer()
    with tr.span("kernel.eval") as sp:
        prof.stamp_kernel(sp, ("broken", "fn"), 3)
    # the tracer's first record is its clock anchor
    assert tr.spans[-1] is sp
    assert sp.attrs["kernel_key"] == "broken:fn"
    assert sp.attrs["cost_flops"] == 0.0
    assert sp.attrs["cost_error"] == "ValueError"


def test_roofline_peaks_and_main_path_cost():
    """The H100 peaks behind the roofline, and the step's shape-only cost
    at the main path's shapes (one lane, EB=512, W=20, Q=8 over the
    440,000-node graph's 294,400-row partitions): 0.8-0.9 MB, memory
    bound, above the 766,692 B its data needed on the card."""
    assert profile.H100_INT32_OPS_PER_S == 132 * 64 * 1980e6
    ops_n, nbytes = ops.step_cost(1, 512, 20, 8, 12, 294_400, 440_000)
    assert 766_692 < nbytes < 900_000
    assert ops_n == 512 * 20 * (40 + 3 * 8)
    r = profile.step_roofline(ops_n, nbytes)
    assert r["dominant"] == "memory"
    assert r["t_bound_us"] == pytest.approx(nbytes / 3.35e12 * 1e6)
    assert profile.step_roofline(1e9, 1)["dominant"] == "compute"


def _random_step(seed, L, EB, W, Q, Np, P, V):
    """Random loop state for the step on the CPU: P partitions of random
    ELL tables over V global ids, one plan per lane, work buffers and a
    selection of EB rows per lane.  Returns (invariants, args)."""
    rng = np.random.default_rng(seed)
    S = 6
    t = torch.from_numpy
    R = P * Np
    dst = rng.integers(-1, Np, size=(R, W)).astype(np.int32)
    tables = [dst, rng.integers(-2, 3, size=(R, W)).astype(np.int32),
              rng.integers(0, 3, size=(R, W)).astype(np.int32),
              rng.integers(-2, 3, size=(R, W)).astype(np.int32),
              rng.normal(size=(R, W)).astype(np.float32),
              np.where(dst >= 0, rng.integers(0, V, size=(R, W)), -1).astype(np.int32)]
    g2l = np.full((P, V), -1, np.int32)
    for p in range(P):
        present = rng.choice(V, size=min(Np, V), replace=False)
        g2l[p, present] = rng.permutation(len(present)).astype(np.int32)
    plan = {f: t(rng.integers(lo, hi, size=(L, S)).astype(np.int32))
            for f, lo, hi in (("src_slot", 0, Q), ("dst_slot", 0, Q),
                              ("edge_label", -1, 3), ("direction", 0, 3),
                              ("dst_label", -1, 3), ("dst_value_op", 0, 7),
                              ("closes_cycle", 0, 2))}
    plan["dst_value"] = t(rng.normal(size=(L, S)).astype(np.float32))
    lane_part = rng.integers(0, P, L)
    inv = ops.step_invariants([t(x).view(P, Np, W) for x in tables], t(g2l),
                              t(rng.integers(0, P, V).astype(np.int32)),
                              types.SimpleNamespace(**plan), t(lane_part),
                              t(rng.integers(1, Np + 1, P)[lane_part]),
                              t(rng.integers(3, S + 1, L)))
    N = EB + 7
    args = (t(rng.integers(-1, V, size=(L, N + 1, Q)).astype(np.int32)),
            t(rng.integers(0, S + 2, size=(L, N + 1)).astype(np.int32)),
            t(rng.integers(-2, Np + 2, size=(L, N)).astype(np.int32)),
            t(np.stack([rng.permutation(N)[:EB] for _ in range(L)])),
            t(rng.random((L, EB)) < 0.8))
    return inv, args


@pytest.mark.parametrize("seed,L,EB,W,Q,Np,P,V", [
    (1, 1, 16, 7, 8, 32, 1, 200),
    (2, 3, 32, 9, 5, 8, 2, 40),        # more selected rows than table rows
    (3, 4, 64, 20, 8, 128, 4, 30),     # fewer vertices than candidates
    (4, 2, 8, 130, 1, 16, 2, 5000),
])
def test_step_cost_bounds_what_the_data_needs(seed, L, EB, W, Q, Np, P, V):
    """``step_cost`` from the shapes alone is never below
    ``step_bytes_ops``'s count on a launch's data, term for term."""
    inv, args = _random_step(seed, L, EB, W, Q, Np, P, V)
    out = ops.step_outputs(L, EB, W, Q, "cpu")
    got = ops.frontier_step(inv, *args, out)
    nbytes, terms, nops = ops.step_bytes_ops(inv, args, got)
    S = inv.plan_int.shape[1]
    bound_ops, bound_bytes = ops.step_cost(L, EB, W, Q, S, Np, V)
    assert bound_ops == nops
    assert bound_bytes >= nbytes > 0
    cand = L * EB * (W + 1)
    bound = ops.step_terms(L, EB, W, Q, S, min(L * EB, L * Np),
                           min(cand, V) + min(cand, L * V))
    assert sum(bound.values()) == bound_bytes
    for k in terms:
        assert bound[k] >= terms[k], k
