"""End-to-end query-serving CLI of the PyTorch port — a thin client of
``GraphSession`` (core/session.py).

Generates a graph database and opens one in-RAM ``GraphSession`` (or,
with ``--graph-dir``, opens a saved graph directory out of core): the
session partitions the graph with the chosen scheme, owns the
``PartitionStore`` (device-resident partitions, LRU capacity via
``--cache-parts``, OPAT runner-up prefetch) and the engine, then serves
the query batch through one of the three strategies (OPAT / TraditionalMP
/ MapReduceMP).  Reported per query: the paper's metrics (partition-load
sequences, load ratios against L_ideal, answer counts, latency) plus the
store's cold/warm/prefetch split; the ``--json`` report also carries the
session's cache counters and per-partition workload profile.

Serving modes:

  * default — the dataset's query batch, one ``submit`` per query (the
    paper's one-at-a-time shape);
  * ``--workload file.jsonl`` — a batch of queries (one JSON query per
    line, optional per-line ``"max_answers"``, ``"arrival_ms"``,
    ``"slo_class"``) served through ``submit_many`` (core/scheduler.py):
    overlapping queries share partition loads (OPAT, TraditionalMP;
    MapReduceMP drains them one query at a time), and the report adds
    aggregate throughput.  ``--emit-workload file.jsonl`` writes the
    dataset's own queries in that format and exits (``--emit-repeat`` /
    ``--emit-arrival-spacing-ms`` / ``--emit-slo-classes`` synthesize
    larger workloads; combined with ``--workload`` it round-trips an
    existing file losslessly);
  * ``--slo SPEC`` — SLO serving through the ``ServingFrontend``
    (serving/frontend.py): cost-predicted admission, deadline-aware
    ranking, and degrade / defer / shed under ``--shed-policy``; per-line
    arrivals replay on a scalable clock (``--arrival-replay``, 0 =
    instant).  Served queries verify under their effective (possibly
    degraded) budget, and a shed query without a ``shed_reason`` fails
    the ``--verify`` gate like an oracle mismatch;
  * ``--mutate-workload N`` (with ``--graph-dir``) — a mutation soak: N
    random durable graph updates interleaved with the dataset's queries,
    hot partitions compacted every ``--mutate-compact-every`` updates;
    ``--verify`` checks each query against the oracle over the overlay
    graph of the generation it was pinned to.

``--verify`` checks every answer set against the whole-graph oracle and
prints ``MATCH``/``MISMATCH`` per query; any mismatch ends the run with a
non-zero exit code.

Every engine runs on ``--device cuda`` (the default; raises with no card)
or ``--device cpu`` (the kernels' plain versions).  MapReduceMP takes the
default part mesh (core/mesh.py): its P mappers as P lanes of one shard
on one card or the CPU, spread over the cards when there are several; it
needs no device-count setting.

    PYTHONPATH=src python -m repro_torch.launch.serve --dataset synthetic \\
        --scale 0.5 --k 4 --engine mapreduce --verify --device cpu

Out of core: ``--save-graph DIR`` writes the session's partitioned graph
as a graph directory, and ``--graph-dir DIR`` serves from one through the
disk → pinned-host → device tiers (``--host-cache-parts``,
``--no-read-ahead``).  ``--repartition-from PROFILE.json`` feeds a saved
workload profile (``--profile-json``) to ``GraphSession.repartition``
before serving, then ``--save-graph`` saves the new layout.

Observability: ``--trace-out T.json`` records the run's spans (and turns
on resource profiling: device live bytes and the frontier step's
predicted cost on every ``kernel.eval`` span, read by
``tools/trace_report.py --cost``), and ``--metrics-out M.prom`` writes the
unified metrics registry (obs/metrics.py) in Prometheus text format.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np

from ..core import (EngineConfig, GraphSession, MAX_SN, MAX_YIELD,
                    MAX_YIELD_SHARED, MIN_SN, RANDOM_SN, SHARED_HEURISTICS,
                    partition_quality)
from ..core.engine import resolve_device
from ..core.metrics import total_connected_components
from ..core.oracle import match_disjunctive
from ..core.query import DisjunctiveQuery
from ..data.generators import (imdb_like_graph, imdb_queries,
                               subgen_like_graph, subgen_queries)
from ..obs import (NULL_TRACER, MetricsRegistry, Tracer, ingest_schedule,
                   ingest_session, observability_snapshot,
                   resource_profile_snapshot, write_chrome_trace,
                   write_prometheus)


def load_queries(name: str, graph, seed: int):
    """The dataset's query batch, built against ``graph``."""
    if name == "imdb":
        return imdb_queries(graph, seed=seed)
    if name == "synthetic":
        return subgen_queries(graph)
    raise ValueError(name)


def load_dataset(name: str, scale: float, seed: int):
    if name == "imdb":
        g = imdb_like_graph(n_movies=int(300 * scale),
                            n_people=int(400 * scale),
                            n_companies=max(4, int(40 * scale)), seed=seed)
    elif name == "synthetic":
        g = subgen_like_graph(n_nodes=int(2000 * scale),
                              n_edges=int(6000 * scale),
                              n_embed=max(5, int(50 * scale)), seed=seed)
    else:
        raise ValueError(name)
    return g, load_queries(name, g, seed)


def _mutation_soak(session, dqueries, oracle_graph, *, n_deltas: int,
                   compact_every: int, seed: int, max_answers):
    """The --mutate-workload serving loop: before each query, apply a
    burst of random durable delta records (~45% edge inserts, ~45% edge
    deletes, ~10% vertex add/tombstone), compacting hot partitions every
    ``compact_every`` deltas; then serve one dataset query against the
    advanced view.  ``oracle_graph["g"]`` is re-pointed at the overlay
    graph the submit pins, so --verify checks each answer against exactly
    that generation.  Yields (query, result, budget)."""
    from ..storage.deltas import DELETED_LABEL
    rng = np.random.default_rng(seed)
    applied = 0
    compacted_at = 0
    qi = 0
    while applied < n_deltas:
        burst = int(min(rng.integers(1, 4), n_deltas - applied))
        for _ in range(burst):
            g = session.graph
            del_id = g.node_vocab.get(DELETED_LABEL, -10)
            alive = np.flatnonzero(np.asarray(g.node_label) != del_id)
            roll = rng.random()
            if roll < 0.45 and alive.size >= 2:
                u, v = rng.choice(alive, size=2, replace=False)
                if g.n_edges:
                    lab = g.edge_vocab.str_of(int(np.asarray(g.edge_label)[
                        int(rng.integers(0, g.n_edges))]))
                else:
                    lab = "soak"
                session.add_edge(int(u), int(v), lab)
            elif roll < 0.90 and g.n_edges:
                i = int(rng.integers(0, g.n_edges))
                session.del_edge(int(np.asarray(g.edge_src)[i]),
                                 int(np.asarray(g.edge_dst)[i]),
                                 g.edge_vocab.str_of(
                                     int(np.asarray(g.edge_label)[i])))
            elif roll < 0.95 and alive.size:
                src = int(rng.choice(alive))
                session.add_vertex(
                    g.node_vocab.str_of(int(np.asarray(g.node_label)[src])),
                    value=float(np.asarray(g.node_value)[src]))
            elif alive.size:
                session.del_vertex(int(rng.choice(alive)))
            applied += 1
        if compact_every and applied - compacted_at >= compact_every:
            pids = session.compact_hot()
            compacted_at = applied
            print(f"[serve] compacted partitions {pids} at delta "
                  f"{applied} -> generation {session.generation}")
        dq = dqueries[qi % len(dqueries)]
        qi += 1
        # the overlay the submit pins: the oracle sees the same vertices
        # and edges the evaluator does
        oracle_graph["g"] = session.graph
        res = session.submit(dq, max_answers=max_answers)
        yield dq, res, max_answers
    print(f"[serve] soak done: {applied} deltas, generation "
          f"{session.generation}, "
          f"{int(session._mdir.pending_counts().sum())} pending")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve subgraph queries on the PyTorch port.")
    ap.add_argument("--dataset", default="imdb", choices=["imdb", "synthetic"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--k", type=int, default=4, help="number of partitions")
    ap.add_argument("--scheme", default="kway_shem")
    ap.add_argument("--engine", default="opat",
                    choices=["opat", "traditional", "mapreduce"])
    ap.add_argument("--heuristic", default=MAX_SN,
                    choices=[MAX_SN, MIN_SN, RANDOM_SN, MAX_YIELD])
    ap.add_argument("--processors", type=int, default=2,
                    help="p for TraditionalMP")
    ap.add_argument("--max-answers", type=int, default=None,
                    help="answer budget K per disjunct: stop after K unique "
                         "answers (default: all)")
    ap.add_argument("--cache-parts", type=int, default=None,
                    help="PartitionStore LRU capacity in partitions "
                         "(default: unbounded)")
    ap.add_argument("--no-prefetch", action="store_true",
                    help="disable OPAT's runner-up partition prefetch")
    ap.add_argument("--graph-dir", default="", metavar="DIR",
                    help="serve OUT OF CORE from this saved graph directory "
                         "(GraphSession.open): --dataset/--seed then only "
                         "name the query batch, --k/--scheme come from the "
                         "manifest")
    ap.add_argument("--save-graph", default="", metavar="DIR",
                    help="after building (and optionally repartitioning) "
                         "the session, save its partitioned graph as a graph "
                         "directory reopenable via --graph-dir")
    ap.add_argument("--host-cache-parts", type=int, default=None,
                    help="with --graph-dir: pinned-host LRU capacity in "
                         "partitions between disk and device (default: "
                         "unbounded)")
    ap.add_argument("--no-read-ahead", action="store_true",
                    help="with --graph-dir: disable the background-thread "
                         "disk read-ahead of the heuristic's runner-up")
    ap.add_argument("--repartition-from", default="", metavar="PROFILE.json",
                    help="before serving, feed this saved workload profile "
                         "(a previous run's --profile-json) to "
                         "GraphSession.repartition() and serve the 'waw' "
                         "layout")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="check answers against the whole-graph oracle")
    ap.add_argument("--cap", type=int, default=16384)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the one device every engine runs on (cpu: the "
                         "kernels' plain versions)")
    ap.add_argument("--json", default="", help="write a JSON report here")
    ap.add_argument("--trace-out", default="", metavar="TRACE.json",
                    help="record end-to-end spans and write a Chrome "
                         "trace-event file loadable in Perfetto; also turns "
                         "on resource profiling (the --json \"profile\" "
                         "block, tools/trace_report.py --cost)")
    ap.add_argument("--metrics-out", default="", metavar="METRICS.prom",
                    help="write the unified metrics registry "
                         "(obs/metrics.py) in Prometheus text exposition "
                         "format at exit")
    ap.add_argument("--profile-json", default="",
                    help="also write the workload profile alone here")
    ap.add_argument("--workload", default="", metavar="FILE.jsonl",
                    help="batch mode: serve the queries of this JSON-lines "
                         "file (optional per-line 'max_answers') through "
                         "submit_many")
    ap.add_argument("--emit-workload", default="", metavar="FILE.jsonl",
                    help="write the dataset's query batch in --workload "
                         "format to this path and exit")
    ap.add_argument("--emit-repeat", type=int, default=1, metavar="N",
                    help="with --emit-workload: the batch N times over")
    ap.add_argument("--emit-arrival-spacing-ms", type=float, default=None,
                    metavar="MS",
                    help="with --emit-workload: arrival_ms = line_index * MS")
    ap.add_argument("--emit-slo-classes", default="", metavar="A,B,...",
                    help="with --emit-workload: slo_class round-robin from "
                         "this comma-separated list")
    ap.add_argument("--shared-heuristic", default=MAX_YIELD_SHARED,
                    choices=list(SHARED_HEURISTICS),
                    help="workload-level partition ranking of --workload")
    ap.add_argument("--fairness-gamma", type=float, default=0.0,
                    help="aging weight (rounds-waiting x SNI) in the shared "
                         "ranking of --workload")
    ap.add_argument("--slo", default="", metavar="SPEC",
                    help="SLO serving: comma-separated name=deadline_seconds "
                         "classes (e.g. 'interactive=0.5,batch=5,"
                         "exhaustive=inf'; order is priority order, known "
                         "names keep their strictness flags), served through "
                         "the ServingFrontend")
    ap.add_argument("--shed-policy", default="predictive",
                    choices=["predictive", "deadline", "never"],
                    help="SLO overload response: 'predictive' degrades "
                         "(shrinks K), defers, then sheds from predicted "
                         "backlog vs deadline; 'deadline' sheds anything "
                         "predicted to miss; 'never' admits all")
    ap.add_argument("--arrival-replay", type=float, default=0.0,
                    metavar="SPEED",
                    help="replay the workload's per-line arrival_ms: 1.0 = "
                         "real time, 2.0 = twice as fast, 0 (default) = "
                         "instant (every arrival due at once, deterministic)")
    ap.add_argument("--default-slo", default="",
                    help="SLO class of workload lines (or dataset queries) "
                         "that carry none (default: no deadline)")
    ap.add_argument("--mutate-workload", type=int, default=0, metavar="N",
                    help="with --graph-dir: a mutation soak of N random "
                         "durable graph updates interleaved with the "
                         "dataset's queries, each query served against its "
                         "pinned generation view")
    ap.add_argument("--mutate-compact-every", type=int, default=0,
                    metavar="M",
                    help="with --mutate-workload: compact_hot after every M "
                         "applied updates (0 = never compact)")
    ap.add_argument("--mutate-seed", type=int, default=0,
                    help="rng seed of the --mutate-workload update stream")
    return ap


def emit_workload(args, dqueries) -> None:
    if args.workload:
        # round-trip: re-emit an existing workload file's parsed lines
        with open(args.workload) as f:
            out_lines = [json.loads(ln) for ln in f if ln.strip()]
    else:
        out_lines = []
        classes = [c for c in args.emit_slo_classes.split(",") if c]
        for _ in range(max(1, args.emit_repeat)):
            for dq in dqueries:
                d = dq.to_json_dict()
                i = len(out_lines)
                if args.emit_arrival_spacing_ms is not None:
                    d["arrival_ms"] = i * args.emit_arrival_spacing_ms
                if classes:
                    d["slo_class"] = classes[i % len(classes)]
                out_lines.append(d)
    with open(args.emit_workload, "w") as f:
        for d in out_lines:
            f.write(json.dumps(d) + "\n")
    print(f"[serve] wrote {len(out_lines)} queries to {args.emit_workload}")


def _throughput(report, fairness_gamma: float) -> dict:
    lat = [r.latency_s for r in report.results]
    return {
        "n_queries": len(report.results),
        "wall_s": report.wall_s,
        "qps": len(report.results) / report.wall_s if report.wall_s else 0.0,
        "shared": report.shared,
        "workload_loads": report.n_loads,
        "loads_per_query": report.loads_per_query,
        "batch_sizes": report.batch_sizes,
        "p50_latency_s": float(np.percentile(lat, 50)) if lat else 0.0,
        "p95_latency_s": float(np.percentile(lat, 95)) if lat else 0.0,
        "p99_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
        "cold_loads": report.load_stats.cold_loads,
        "warm_loads": report.load_stats.warm_loads,
        "prefetch_hits": report.load_stats.prefetch_hits,
        "disk_reads": report.load_stats.disk_reads,
        "read_ahead_hits": report.load_stats.read_ahead_hits,
        "fairness_gamma": fairness_gamma,
    }


def _verified(answers: np.ndarray, ref: np.ndarray, budget) -> bool:
    if budget is None:
        return (answers.shape[0] == ref.shape[0]
                and (answers.shape[0] == 0
                     or np.array_equal(np.unique(answers, axis=0), ref)))
    # budgeted run: every returned row is a real answer, and each disjunct
    # returning min(K, total_d) rows means the union never falls below
    # min(K, ref_total)
    refset = {tuple(r) for r in ref}
    return (all(tuple(r) in refset for r in answers)
            and answers.shape[0] >= min(budget, ref.shape[0]))


def main(argv: Optional[List[str]] = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    # no card and no --device cpu: raise before the graph is built
    resolve_device(args.device)

    tracer = Tracer() if args.trace_out else NULL_TRACER
    t0 = time.time()
    if args.graph_dir:
        session = GraphSession.open(args.graph_dir, engine=args.engine,
                                    heuristic=args.heuristic,
                                    config=EngineConfig(cap=args.cap),
                                    cache_parts=args.cache_parts,
                                    host_cache_parts=args.host_cache_parts,
                                    read_ahead=not args.no_read_ahead,
                                    processors=args.processors,
                                    prefetch=not args.no_prefetch,
                                    seed=args.seed, tracer=tracer,
                                    device=args.device)
        graph = session.graph
        dqueries = load_queries(args.dataset, graph, args.seed)
        print(f"[serve] graph: {graph.n_nodes} nodes, {graph.n_edges} "
              f"edges (opened out of core from {args.graph_dir}: "
              f"{session.pg.backing.total_part_bytes()} shard bytes on "
              f"disk, host cache "
              f"{args.host_cache_parts or 'unbounded'} parts)")
    else:
        graph, dqueries = load_dataset(args.dataset, args.scale, args.seed)
        print(f"[serve] graph: {graph.n_nodes} nodes, {graph.n_edges} edges")
    # --verify's oracle graph: the one graph in static modes; the mutation
    # soak re-points it at each query's pinned overlay graph
    oracle_graph = {"g": graph}
    if args.emit_workload:
        emit_workload(args, dqueries)
        return 0

    if not args.graph_dir:
        session = GraphSession(graph, k=args.k, scheme=args.scheme,
                               engine=args.engine, heuristic=args.heuristic,
                               config=EngineConfig(cap=args.cap),
                               cache_parts=args.cache_parts,
                               processors=args.processors,
                               prefetch=not args.no_prefetch,
                               seed=args.seed, tracer=tracer,
                               device=args.device)
    gen0 = session.generation   # None in RAM
    q = partition_quality(graph, session.pg.assignment, session.k)
    print(f"[serve] session: k={session.k} scheme={session.scheme} "
          f"engine={args.engine} device={session.device} cut={q['cut']} "
          f"({q['cut_frac']:.1%}) sizes={q['sizes']} "
          f"total_cc={total_connected_components(session.pg)} "
          f"cache_parts={args.cache_parts or 'unbounded'} "
          f"[{time.time()-t0:.1f}s]")

    if args.repartition_from:
        info = session.repartition(args.repartition_from)
        q = partition_quality(graph, session.pg.assignment, session.k)
        print(f"[serve] repartitioned from {args.repartition_from}: "
              f"scheme={session.scheme} cut {info['cut_before']} -> "
              f"{info['cut_after']} ({q['cut_frac']:.1%}) "
              f"sizes={q['sizes']} "
              f"total_cc={total_connected_components(session.pg)}")

    if args.save_graph:
        manifest = session.save(args.save_graph)
        total = sum(p["nbytes"] for p in manifest["partitions"])
        print(f"[serve] saved graph directory {args.save_graph}: "
              f"k={manifest['k']} scheme={manifest['scheme']} "
              f"{total} shard bytes (reopen with --graph-dir)")

    throughput = None
    slo_report = None
    sched_report = None
    if args.slo:
        from ..serving import Request, parse_slo_spec, requests_from_workload
        classes = parse_slo_spec(args.slo)
        default_slo = args.default_slo or None
        if default_slo and default_slo not in {c.name for c in classes}:
            sys.exit(f"[serve] --default-slo {default_slo!r} is not in the "
                     f"--slo spec")
        if args.workload:
            with open(args.workload) as f:
                lines = [json.loads(ln) for ln in f if ln.strip()]
            requests = requests_from_workload(
                lines, default_slo=default_slo,
                default_max_answers=args.max_answers)
        else:
            requests = [Request(dq, slo_class=default_slo,
                                max_answers=args.max_answers)
                        for dq in dqueries]
        replay = (f"x{args.arrival_replay:g}" if args.arrival_replay > 0
                  else "instant")
        print(f"[serve] slo serving: {len(requests)} requests, classes "
              f"[{', '.join(f'{c.name}={c.deadline_s}s' for c in classes)}]"
              f", policy={args.shed_policy}, replay={replay}")
        fe = session.frontend(slo_classes=classes,
                              shed_policy=args.shed_policy,
                              heuristic=args.shared_heuristic,
                              fairness_gamma=args.fairness_gamma,
                              replay_speed=args.arrival_replay)
        slo_report = fe.serve(requests)
        lat = [o.latency_s for o in slo_report.served]
        throughput = {
            "n_queries": len(slo_report.served),
            "wall_s": slo_report.wall_s,
            "qps": (len(slo_report.served) / slo_report.wall_s
                    if slo_report.wall_s else 0.0),
            "p50_latency_s": float(np.percentile(lat, 50)) if lat else 0.0,
            "p95_latency_s": float(np.percentile(lat, 95)) if lat else 0.0,
            "p99_latency_s": float(np.percentile(lat, 99)) if lat else 0.0,
            "fairness_gamma": args.fairness_gamma,
            "slo": {
                "classes": slo_report.per_class,
                "counters": slo_report.counters,
                "shed_by_reason": slo_report.shed_by_reason,
                "rounds": slo_report.rounds,
                "shed_policy": args.shed_policy,
                "cost_model": fe.cost_model.snapshot(),
                "slo_burn": slo_report.slo_burn,
            },
        }
        # each served outcome verifies under its effective budget (a
        # degraded query's shrunken K is the contract it was served under)
        served = (((req.query if isinstance(req.query, DisjunctiveQuery)
                    else DisjunctiveQuery([req.query], name=req.query.name)),
                   o.result, o.max_answers)
                  for req, o in zip(requests, slo_report.outcomes)
                  if o.status == "ok")
        slo_extras = iter(
            [{"status": "ok", "slo_class": o.slo_class,
              "degraded": o.degraded, "deferred": o.deferred,
              "deadline_s": o.deadline_s, "deadline_met": o.deadline_met,
              "predicted_latency_s": o.predicted_latency_s,
              "effective_max_answers": o.max_answers}
             for o in slo_report.served])
    elif args.workload:
        with open(args.workload) as f:
            lines = [json.loads(ln) for ln in f if ln.strip()]
        wqueries = [DisjunctiveQuery.from_json_dict(d) for d in lines]
        budgets = [d.get("max_answers", args.max_answers) for d in lines]
        print(f"[serve] workload: {len(wqueries)} queries from "
              f"{args.workload} via the shared scheduler "
              f"({args.shared_heuristic})")
        report = sched_report = session.submit_many(wqueries, max_answers=budgets,
                                     heuristic=args.shared_heuristic,
                                     fairness_gamma=args.fairness_gamma)
        throughput = _throughput(report, args.fairness_gamma)
        served = zip(wqueries, report.results, budgets)
    elif args.mutate_workload:
        if not args.graph_dir:
            sys.exit("[serve] --mutate-workload needs --graph-dir (durable "
                     "delta logs live in the graph directory)")
        print(f"[serve] mutation soak: {args.mutate_workload} deltas "
              f"(seed {args.mutate_seed}), compact every "
              f"{args.mutate_compact_every or 'never'}")
        served = _mutation_soak(session, dqueries, oracle_graph,
                                n_deltas=args.mutate_workload,
                                compact_every=args.mutate_compact_every,
                                seed=args.mutate_seed,
                                max_answers=args.max_answers)
    else:
        served = ((dq, session.submit(dq, max_answers=args.max_answers),
                   args.max_answers) for dq in dqueries)

    records = []
    mismatches = 0
    if slo_report is not None:
        for o in slo_report.shed:
            print(f"[serve] {o.name}: SHED ({o.shed_reason}) "
                  f"class={o.slo_class} "
                  f"predicted={o.predicted_latency_s*1000:.0f} ms vs "
                  f"deadline={o.deadline_s*1000:.0f} ms")
            # a shed query must say why: a missing reason fails the gate
            if args.verify and not o.shed_reason:
                mismatches += 1
            records.append({"query": o.name, "status": "shed",
                            "slo_class": o.slo_class,
                            "shed_reason": o.shed_reason,
                            "predicted_latency_s": o.predicted_latency_s,
                            "deadline_s": o.deadline_s})
    for dq, res, budget in served:
        answers = res.answers
        n_loads = res.n_loads
        l_ideal = max(s.l_ideal for s in res.stats)
        iters = max(s.iterations for s in res.stats)
        ls = res.load_stats
        print(f"[serve] {dq.name}: answers={answers.shape[0]:5d} "
              f"loads={n_loads} (cold={ls.cold_loads} warm={ls.warm_loads} "
              f"pf_hits={ls.prefetch_hits}) L_ideal={l_ideal} iters={iters} "
              f"latency={res.latency_s*1000:.0f} ms "
              f"load_seq={[s.loads for s in res.stats]}")
        rec = {"query": dq.name, "answers": int(answers.shape[0]),
               "loads": n_loads, "l_ideal": l_ideal, "iterations": iters,
               "latency_s": res.latency_s,
               "cold_loads": ls.cold_loads, "warm_loads": ls.warm_loads,
               "prefetch_hits": ls.prefetch_hits,
               "disk_reads": ls.disk_reads,
               "read_ahead_hits": ls.read_ahead_hits,
               "generation": res.generation}
        if slo_report is not None:
            rec.update(next(slo_extras))
        if args.verify:
            ref = match_disjunctive(oracle_graph["g"], dq, q_pad=answers.shape[1])
            match = _verified(answers, ref, budget)
            rec["oracle_match"] = bool(match)
            mismatches += int(not match)
            print(f"        oracle: {ref.shape[0]} answers "
                  f"{'MATCH' if match else 'MISMATCH'}")
        records.append(rec)

    if throughput is not None and slo_report is not None:
        c = throughput["slo"]["counters"]
        print(f"[serve] slo: {c['arrived']} arrived, {c['admitted']} "
              f"admitted, {c['served']} served "
              f"({c['degraded']} degraded, {c['deferred']} deferred), "
              f"{c['shed']} shed {throughput['slo']['shed_by_reason']}, "
              f"{throughput['slo']['rounds']} scheduler rounds")
        for cls, pc in throughput["slo"]["classes"].items():
            print(f"[serve]   {cls}: {int(pc['served'])} served, "
                  f"p50={pc['p50_latency_s']*1000:.0f} ms "
                  f"p95={pc['p95_latency_s']*1000:.0f} ms "
                  f"p99={pc['p99_latency_s']*1000:.0f} ms")
    elif throughput is not None:
        print(f"[serve] throughput: {throughput['n_queries']} queries in "
              f"{throughput['wall_s']:.2f}s -> {throughput['qps']:.1f} q/s, "
              f"{throughput['workload_loads']} workload loads "
              f"({throughput['loads_per_query']:.2f}/query, "
              f"cold={throughput['cold_loads']} "
              f"warm={throughput['warm_loads']}), "
              f"p50={throughput['p50_latency_s']*1000:.0f} ms "
              f"p95={throughput['p95_latency_s']*1000:.0f} ms "
              f"p99={throughput['p99_latency_s']*1000:.0f} ms")

    cache = session.load_stats.to_dict()
    print(f"[serve] session cache: {cache['cold_loads']} cold / "
          f"{cache['warm_loads']} warm loads "
          f"(hit rate {cache['hit_rate']:.1%}), "
          f"{cache['evictions']} evictions, "
          f"{cache['prefetch_issued']} prefetches "
          f"({cache['prefetch_hits']} hit), "
          f"{cache['bytes_cold']} cold bytes")
    if session.out_of_core:
        print(f"[serve] disk tier: {cache['disk_reads']} shard reads "
              f"({cache['bytes_disk']} bytes), "
              f"{cache['read_ahead_issued']} read-aheads "
              f"({cache['read_ahead_hits']} hit), "
              f"{cache['host_evictions']} host evictions")

    # the registry absorbs every subsystem's counters at exit, whether or
    # not spans were recorded
    registry = MetricsRegistry()
    ingest_session(registry, session)
    if sched_report is not None:
        ingest_schedule(registry, sched_report.loads, sched_report.batch_sizes)
    if args.trace_out:
        write_chrome_trace(tracer, args.trace_out)
        print(f"[serve] wrote Chrome trace ({len(tracer.spans)} spans, "
              f"{len(tracer.decisions)} decisions) to {args.trace_out}")
    if args.metrics_out:
        write_prometheus(registry, args.metrics_out)
        print(f"[serve] wrote Prometheus metrics to {args.metrics_out}")
    if args.json or args.profile_json:
        profile = session.workload_profile()
        if args.json:
            # schema_version 3: the "profile" block holds the resource
            # profiler's peaks, per-kernel predicted costs and byte flows
            rep = {"schema_version": 3,
                   "queries": records,
                   "cache": cache,
                   "observability": observability_snapshot(tracer, registry),
                   "profile": resource_profile_snapshot(session),
                   "workload_profile": profile}
            if session.mutable:
                rep["generations"] = {
                    "start": gen0,
                    "end": session.generation,
                    "compactions": session._mdir.compactions,
                    "pending_deltas": int(session._mdir.pending_counts().sum()),
                }
            if throughput is not None:
                rep["throughput"] = throughput
            with open(args.json, "w") as f:
                json.dump(rep, f, indent=2)
        if args.profile_json:
            with open(args.profile_json, "w") as f:
                json.dump(profile, f, indent=2)
    if mismatches:   # --verify is a gate: fail on MISMATCH
        sys.exit(f"[serve] {mismatches} quer{'y' if mismatches == 1 else 'ies'} "
                 f"MISMATCHED the oracle")
    return 0


if __name__ == "__main__":
    sys.exit(main())
