#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py [--scale 200] [--seed 0]

Phases, each printing one JSON line:

  device   the card's name and power limit (nvidia-smi); no card -> exit 2
  build    nvcc builds every kernel under src/repro_torch/kernels/csrc
           (one process per source, all at once), with ptxas registers
           and spills
  kernels  each kernel against its plain PyTorch version on the card, on
           the test sweep and at the main path's shape, and timed with
           CUDA events beside its byte bound
  small    a small graph served on the card and on the CPU (plain
           versions): identical answers, loads and iterations
  path     the main path: the synthetic graph at the paper's size
           (``--scale 200``: 440,000 nodes, 1,240,000 edges), one in-RAM
           GraphSession with the OPAT engine, the three subgen queries and
           Q4 again under an answer budget, each checked against the
           whole-graph oracle; the kernel launch counts must be > 0 and
           equal the evaluator's summed expansion iterations
  profile  one warm Q5 under torch.profiler: device busy/idle share,
           device time by kernel name, host time by op

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power-limit
line, and last ``{"ok": true, "device": {...}}``.  Any failed check raises,
so the script exits non-zero and prints no result.  The full record is
also written to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM peak outside the tensor cores
RECORD: dict = {}


def emit(phase: str, **kw) -> None:
    RECORD[phase] = kw
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_time_ms(fn, reps: int = 200, replays: int = 10) -> float:
    """Device time per call: ``reps`` calls captured into one CUDA graph
    and replayed, so host-side launch overhead drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


# ---------------------------------------------------------------------------
# kernels: fused_frontier against its plain version
# ---------------------------------------------------------------------------

def fused_case(rng, EB, W, Q, Np, V, *, empty=False, dev="cuda"):
    """Random kernel-level inputs, as the engine would pack them: plan
    parameters through ops._fused_params, locality tables through
    ops.denorm_locality.  ~20% NaN destination values, steps drawn past
    n_steps, and (``empty``) an all-inactive frontier."""
    from repro_torch.core.engine import plan_to_device
    from repro_torch.core.plan import PlanArrays
    from repro_torch.kernels import ops

    S, n_steps = 6, 5
    plan = PlanArrays(
        n_slots=Q, n_steps=S, start_slot=np.int32(0), start_label=np.int32(0),
        start_value_op=np.int32(0), start_value=np.float32(0),
        src_slot=rng.integers(0, Q, S).astype(np.int32),
        dst_slot=rng.integers(0, Q, S).astype(np.int32),
        edge_label=rng.integers(-1, 3, S).astype(np.int32),
        direction=rng.integers(0, 3, S).astype(np.int32),
        dst_label=rng.integers(-1, 3, S).astype(np.int32),
        dst_value_op=rng.integers(0, 7, S).astype(np.int32),
        dst_value=rng.normal(size=S).astype(np.float32),
        closes_cycle=rng.integers(0, 2, S).astype(np.int32))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    dst = rng.integers(-1, Np, size=(Np, W)).astype(np.int32)
    dval = rng.normal(size=(Np, W)).astype(np.float32)
    dval[rng.random((Np, W)) < 0.2] = np.nan
    tables = [t(dst),
              t(rng.integers(-2, 3, size=(Np, W)).astype(np.int32)),
              t(rng.integers(0, 3, size=(Np, W)).astype(np.int32)),
              t(rng.integers(-2, 3, size=(Np, W)).astype(np.int32)),
              t(dval),
              t(np.where(dst >= 0, rng.integers(0, V, size=(Np, W)), -1).astype(np.int32))]
    g2l = np.full(V, -1, np.int32)
    present = rng.choice(V, size=min(Np, V), replace=False)
    g2l[present] = rng.permutation(len(present)).astype(np.int32)
    g2l, owner = t(g2l), t(rng.integers(0, 4, V).astype(np.int32))
    n_core = int(rng.integers(1, Np + 1))
    rows = t(rng.integers(-1, V, size=(EB, Q)).astype(np.int32))
    step = t(rng.integers(0, S + 2, size=EB).astype(np.int32))
    lidx = t(rng.integers(0, Np, size=EB).astype(np.int32))
    m = t(np.zeros(EB, bool) if empty else rng.random(EB) < 0.8)
    pint, pflt, _ = ops._fused_params(rows, step, m, g2l, owner, n_core,
                                      plan_to_device(plan, dev), n_steps)
    dlidx, downer = ops.denorm_locality(tables[5], g2l, owner)
    return (lidx, pint, pflt, rows, *tables, dlidx, downer)


def compare_fused(got, want, args) -> dict:
    """Masks bit-equal, dg where an edge exists, dest where routed out,
    done/keep/out disjoint and covering ok.  Returns the error record."""
    ok, dg, done, keep, out, dest = got
    wok, wdg, wdone, wkeep, wout, wdest = want
    mism = sum(int((a != b).sum()) for a, b in
               ((ok, wok), (done, wdone), (keep, wkeep), (out, wout)))
    edge = args[4][args[0].long()] >= 0
    err_dg = int((dg - wdg).abs()[edge].max()) if bool(edge.any()) else 0
    err_dest = int((dest - wdest).abs()[wout].max()) if bool(wout.any()) else 0
    disjoint = not bool((done & keep).any() | (done & out).any() | (keep & out).any())
    covers = bool(torch.equal(done | keep | out, ok))
    return {"mask_mismatches": mism, "max_abs_err": max(err_dg, err_dest),
            "disjoint": disjoint, "covers_ok": covers,
            "n_ok": int(ok.sum())}


def fused_bytes_ops(args) -> tuple:
    """Bytes the call must move (each input read once — only the table
    rows this run's lidx selects — each output written once) and its
    elementwise integer operations."""
    lidx, pint, pflt, rows = args[:4]
    EB, Q = rows.shape
    W = args[4].shape[1]
    rows_read = int(torch.unique(lidx).numel())
    table_bytes = sum(rows_read * W * t.element_size() for t in args[4:])
    scalar_bytes = sum(x.numel() * x.element_size() for x in (lidx, pint, pflt, rows))
    out_bytes = EB * W * (4 * 1 + 2 * 4)
    ops_count = EB * W * (40 + 2 * Q)
    return table_bytes + scalar_bytes + out_bytes, ops_count


def phase_kernels(seed: int) -> dict:
    from repro_torch.kernels import fused_frontier as ff

    rng = np.random.default_rng(seed)
    cases = [("sweep", (4, 4, 4, 8), {}), ("sweep", (16, 7, 6, 32), {}),
             ("sweep", (32, 128, 8, 64), {}), ("sweep", (8, 130, 5, 16), {}),
             ("sweep", (1, 1, 1, 1), {}),
             ("empty", (8, 16, 4, 8), {"empty": True}),
             ("paper_empty", (512, 20, 8, 294_648), {"empty": True}),
             ("paper", (512, 20, 8, 294_648), {})]
    results, worst = [], 0
    for name, (EB, W, Q, Np), kw in cases:
        args = fused_case(rng, EB, W, Q, Np, V=max(1000, 2 * Np), **kw)
        got = ff.fused_frontier_cuda(*args)
        torch.cuda.synchronize()
        want = ff.fused_frontier_plain(*args)
        rec = compare_fused(got, want, args)
        rec.update(case=name, EB=EB, W=W, Q=Q, Np=Np)
        results.append(rec)
        check(rec["mask_mismatches"] == 0 and rec["max_abs_err"] == 0
              and rec["disjoint"] and rec["covers_ok"],
              f"fused_frontier disagrees with its plain version: {rec}")
        worst = max(worst, rec["max_abs_err"])
        if kw.get("empty"):
            check(rec["n_ok"] == 0, f"empty frontier matched something: {rec}")
        if name == "paper":
            check(rec["n_ok"] > 0, "paper-shape case matched nothing")
            paper = args
    # the kernel's own device time (CUDA graph replay), and the time per
    # call through the Python wrapper, back to back, as the path pays it
    ms = graph_time_ms(lambda: ff.fused_frontier_cuda(*paper))
    call_ms = cuda_time_ms(lambda: ff.fused_frontier_cuda(*paper), reps=5000, warmup=100)
    plain_ms = cuda_time_ms(lambda: ff.fused_frontier_plain(*paper), reps=300)
    nbytes, nops = fused_bytes_ops(paper)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = nops / FP32_OPS_PER_S * 1e3
    timing = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bytes": nbytes, "ops": nops,
              "bound_ms": max(bound_bytes_ms, bound_ops_ms),
              "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
              "library_ms": None, "max_abs_err": worst}
    emit("kernels", cases=results, fused_frontier=timing)
    return timing


# ---------------------------------------------------------------------------
# serving: small CPU-vs-card parity, then the main path at full size
# ---------------------------------------------------------------------------

def phase_small(seed: int) -> None:
    from repro_torch.core import EngineConfig, GraphSession
    from repro_torch.data.generators import subgen_like_graph, subgen_queries
    g = subgen_like_graph(n_nodes=2000, n_edges=6000, n_embed=50, seed=seed)
    qs = subgen_queries(g)
    runs = {}
    for dev in ("cuda", "cpu"):
        sess = GraphSession(g, config=EngineConfig(cap=16384), device=dev)
        runs[dev] = [sess.submit(dq) for dq in qs]
    out = []
    for a, b in zip(runs["cuda"], runs["cpu"]):
        same = (np.array_equal(a.answers, b.answers)
                and [r.stats.loads for r in a.reports] == [r.stats.loads for r in b.reports]
                and [r.stats.iterations for r in a.reports]
                == [r.stats.iterations for r in b.reports])
        check(same, f"{a.name}: card and CPU runs differ")
        out.append({"query": a.name, "n_answers": a.n_answers, "n_loads": a.n_loads})
    emit("small", nodes=g.n_nodes, edges=g.n_edges, queries=out)


def phase_path(scale: float, seed: int) -> int:
    from repro_torch.core.oracle import match_disjunctive
    from repro_torch.data.generators import subgen_like_graph, subgen_queries
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_frontier import NAME

    t0 = time.perf_counter()
    g = subgen_like_graph(n_nodes=int(2000 * scale), n_edges=int(6000 * scale),
                          n_embed=max(5, int(50 * scale)), seed=seed)
    t_graph = time.perf_counter() - t0
    from repro_torch.core import EngineConfig, GraphSession
    sess = GraphSession(g, k=4, scheme="kway_shem", engine="opat",
                        heuristic="max-sn", config=EngineConfig(cap=16384),
                        device="cuda")
    t_setup = time.perf_counter() - t0
    dqs = subgen_queries(g)
    runs = [(dq, None) for dq in dqs] + [(dqs[0], 5)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.LAUNCHES.clear()
    sess.engine.inner_iters = 0
    served = []
    for dq, budget in runs:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = sess.submit(dq, max_answers=budget)
        torch.cuda.synchronize()
        served.append((dq, budget, res, time.perf_counter() - t1))
    launches = build.LAUNCHES[NAME]
    inner = sess.engine.inner_iters
    peak = torch.cuda.max_memory_allocated()

    queries = []
    t2 = time.perf_counter()
    for dq, budget, res, lat in served:
        want = match_disjunctive(g, dq, q_pad=8)
        if budget is None:
            right = np.array_equal(res.answers, want)
        else:
            wset = {tuple(r) for r in want}
            right = (res.n_answers == min(budget, len(wset))
                     and all(tuple(r) in wset for r in res.answers))
        check(right, f"{dq.name} (budget {budget}) disagrees with the oracle")
        st = res.reports[0].stats
        queries.append({"query": dq.name, "max_answers": budget,
                        "n_answers": res.n_answers, "oracle_answers": int(want.shape[0]),
                        "verified": True, "latency_s": lat, "loads": st.loads,
                        "iterations": st.iterations,
                        "cold_loads": res.load_stats.cold_loads,
                        "warm_loads": res.load_stats.warm_loads,
                        "prefetch_hits": res.load_stats.prefetch_hits,
                        "bytes_cold": res.load_stats.bytes_cold,
                        "bytes_prefetched": res.load_stats.bytes_prefetched})
    t_oracle = time.perf_counter() - t2
    check(launches > 0, "the main path launched no fused_frontier kernel")
    check(launches == inner,
          f"fused_frontier launches {launches} != summed EvalResult.n_iters {inner}")
    emit("path", scale=scale, nodes=g.n_nodes, edges=g.n_edges,
         node_pad=sess.pg.node_pad, ell_width=sess.pg.ell_width,
         host_graph_s=t_graph, host_setup_s=t_setup, oracle_s=t_oracle,
         max_memory_allocated=peak,
         host_peak_rss_kib=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
         fused_frontier_launches=launches,
         eval_inner_iters=inner, queries=queries)
    return launches, sess, dqs


def phase_profile(sess, dq) -> None:
    """One warm query under torch.profiler: the device's busy and idle
    share of the query's wall time and device time by kernel name (read
    from the exported Chrome trace), and host time by op."""
    from torch.profiler import ProfilerActivity, profile
    out = ROOT / "chiprun_out" / f"profile_{dq.name}.json"
    out.parent.mkdir(exist_ok=True)
    sess.submit(dq)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.submit(dq)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(bool(dev), "the profiler recorded no device activity")
    by_name: dict = {}
    for e in dev:
        d = by_name.setdefault(e["name"][:90], [0.0, 0])
        d[0] += e["dur"] / 1e3
        d[1] += 1
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_us, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            busy_us += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    busy_us += hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    ours = [v for n, v in by_name.items() if "fused_frontier" in n]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]
    emit("profile", query=dq.name, wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
         device_idle_share=1.0 - busy_us / 1e3 / wall_ms, device_events=len(dev),
         fused_frontier_ms=sum(v[0] for v in ours),
         fused_frontier_count=sum(v[1] for v in ours),
         kernels_by_device_time=[{"name": n, "ms": v[0], "count": v[1]}
                                 for n, v in top],
         host_ops_by_self_cpu_time=[{"name": e.key, "ms": e.self_cpu_time_total / 1e3,
                                     "count": e.count} for e in host])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=200.0,
                    help="synthetic dataset scale (200 = the paper's 400K/1200K)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    emit("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    info = build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         kernels={n: {k: v for k, v in d.items() if k != "log"} for n, d in info.items()})

    timing = phase_kernels(args.seed)
    phase_small(args.seed)
    launches, sess, dqs = phase_path(args.scale, args.seed)
    phase_profile(sess, dqs[1])

    kernels = [{"name": "fused_frontier", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/fused_frontier.cu",
                "replaces": "src/repro/kernels/fused_frontier.py:61",
                "launches": launches, "max_abs_err": timing["max_abs_err"],
                "ms": timing["ms"], "plain_ms": timing["plain_ms"],
                "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
                "library_ms": timing["library_ms"]}]
    RECORD["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(RECORD, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
