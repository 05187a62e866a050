"""GraphSession — the stateful serving API over one partitioned graph.

The paper's workload is *query serving*: many queries, one partitioned
graph, response time dominated by the partition-load sequence.  A
``GraphSession`` is constructed once from (graph, scheme, k, engine,
EngineConfig) and then serves repeated ``submit`` calls against the same
residency state:

  * it owns the ``PartitionStore`` (core/store.py), so the second query
    finds the first query's partitions device-resident — warm loads — and
    OPAT's runner-up prefetch overlaps copies with evaluation;
  * it owns the catalog and the engine;
  * it accumulates per-partition loads, completed vs spawned rows, and the
    per-answer partition-span matrix.

``submit(query, max_answers=K)`` accepts a conjunctive ``Query`` or a
``DisjunctiveQuery`` (per-disjunct plans, unioned answers; a budget K
applies per disjunct) and returns a ``QueryResult``.  ``submit_many``
serves a batch through the shared-load ``QueryScheduler``
(core/scheduler.py), whose ``ScheduleReport`` holds one ``QueryResult``
per query.

The session serves the OPAT, TraditionalMP and MapReduceMP engines and
keeps the per-partition workload profile (``workload_profile`` /
``save_profile``).  ``repartition()`` feeds that profile to
core/repartition.py and rebinds the session to the workload-aware layout.

``save(path)`` / ``open(path)`` round the partitioned graph through disk
(storage/): a saved *graph directory* reopens as an out-of-core session
whose partitions stream through the store's disk → pinned-host → device
cache tiers with identical answers.  It opens *mutable*
(storage/deltas.py): the session holds one pinned generation view,
``mutate`` / ``add_edge`` / ``del_edge`` / ``add_vertex`` / ``del_vertex``
append durable delta records and advance the view, and ``compact`` /
``compact_all`` / ``compact_hot`` / ``fold`` publish new generations.
Every ``submit`` and ``submit_many`` runs under one view from start to
end, so a query pinned to generation G answers from G while newer ones
are published.

``frontend(**kw)`` builds the SLO serving front end
(serving/frontend.py) over the session; ``record_serving`` folds its
admission counters and per-class latencies into the workload profile's
``"serving"`` block.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..obs.profile import NULL_PROFILER, ResourceProfiler
from ..obs.trace import NULL_TRACER
from .catalog import Catalog, build_catalog
from .engine import EngineConfig, resolve_device
from .graph import Graph, PartitionedGraph, build_partitions
from .heuristics import MAX_SN
from .mapreduce_mp import MapReduceMPEngine
from .mesh import PartMesh
from .metrics import RunStats
from .opat import OPATEngine
from .partition import partition_graph, partition_quality
from .plan import generate_plan
from .query import DisjunctiveQuery, Query
from .repartition import RepartitionConfig, answer_span_matrix
from .repartition import repartition as repartition_pg
from .runner import RunReport, RunRequest
from .store import LoadStats, PartitionStore
from .traditional_mp import TraditionalMPEngine

ENGINES = ("opat", "traditional", "mapreduce")


@dataclasses.dataclass
class QueryResult:
    """What ``GraphSession.submit`` returns for one (possibly disjunctive)
    query: merged unique answers plus everything observability needs."""

    name: str
    answers: np.ndarray            # [n, q_pad] unique rows (union of disjuncts)
    reports: List[RunReport]       # one per disjunct, in disjunct order
    latency_s: float
    load_stats: LoadStats          # this call's store delta (cold/warm/prefetch)
    qid: Optional[int] = None      # scheduler admission id (None on submit)
    generation: Optional[int] = None   # graph generation the result was
                                       # pinned to; None in RAM

    @property
    def n_answers(self) -> int:
        return int(self.answers.shape[0])

    @property
    def stats(self) -> List[RunStats]:
        return [r.stats for r in self.reports]

    @property
    def n_loads(self) -> int:
        return sum(s.n_loads for s in self.stats)


class GraphSession:
    """One partitioned graph, one engine, many queries.

    ``engine`` is ``"opat"``, ``"traditional"`` (with ``processors``
    partitions per iteration) or ``"mapreduce"`` (one mapper per
    partition, the session's ``heuristic`` fixed at construction), whose
    mappers ``mesh`` (core/mesh.py) spreads over devices; None is
    ``default_part_mesh`` on the session's device (one shard of k lanes on
    one card).
    ``cache_parts`` / ``cache_bytes`` size the store's LRU device cache
    (None = unbounded); ``prefetch`` enables OPAT's runner-up staging.
    Pass ``pg`` to reuse an existing ``PartitionedGraph``.  ``device=None``
    means ``"cuda"``.

    Out of core: ``GraphSession.open(path)`` builds a session over a
    ``save``d graph directory, with ``host_cache_parts`` /
    ``host_cache_bytes`` sizing the pinned-host LRU and ``read_ahead``
    enabling the background-thread disk staging of the heuristic's
    runner-up (all three are ignored for in-RAM sessions, whose host tier
    is the whole graph).

    ``tracer`` (obs/trace.py) records spans across the store, engines and
    scheduler; ``profiler`` (obs/profile.py) defaults to a
    ``ResourceProfiler`` whenever that tracer is real, which stamps device
    live bytes and the frontier step's predicted cost on them.
    """

    def __init__(self, graph: Optional[Graph] = None, *,
                 k: int = 4,
                 scheme: str = "kway_shem",
                 engine: str = "opat",
                 heuristic: str = MAX_SN,
                 config: Optional[EngineConfig] = None,
                 cache_parts: Optional[int] = None,
                 cache_bytes: Optional[int] = None,
                 host_cache_parts: Optional[int] = None,
                 host_cache_bytes: Optional[int] = None,
                 read_ahead: bool = True,
                 processors: int = 2,
                 prefetch: bool = True,
                 seed: int = 0,
                 pg: Optional[PartitionedGraph] = None,
                 catalog: Optional[Catalog] = None,
                 tracer: Optional[Any] = None,
                 device: Union[None, str, torch.device] = None,
                 profiler: Optional[Any] = None,
                 mesh: Optional[PartMesh] = None):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        self.device = resolve_device(device)
        if pg is None:
            if graph is None:
                raise ValueError("need a graph (or a pre-built pg)")
            assign = partition_graph(graph, k, scheme, seed=seed)
            pg = build_partitions(graph, assign, k, scheme=scheme)
        self.graph = pg.graph
        self.engine_name = engine
        self.heuristic = heuristic
        self.seed = seed
        self.config = config or EngineConfig()
        self.catalog = catalog if catalog is not None else build_catalog(self.graph)
        # remembered so repartition() can rebuild the stack identically
        self._cache_parts = cache_parts
        self._cache_bytes = cache_bytes
        # the disk tier (out-of-core sessions, GraphSession.open): the
        # DiskCatalog the store's host LRU reads shards from, plus that
        # LRU's sizing and read-ahead switch (storage/host_cache.py)
        self._backing = getattr(pg, "backing", None)
        self._host_cache_parts = host_cache_parts
        self._host_cache_bytes = host_cache_bytes
        self._read_ahead = read_ahead
        self._processors = processors
        self._prefetch = prefetch
        self._mesh = mesh
        self.repartitions = 0
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # resource profiling (obs/profile.py): on whenever a real tracer is
        # attached, the no-op singleton otherwise; an explicit profiler
        # (or NULL_PROFILER) decouples the two
        if profiler is not None:
            self.profiler = profiler
        elif self.tracer.enabled:
            self.profiler = ResourceProfiler(self.tracer)
        else:
            self.profiler = NULL_PROFILER
        self.store: Optional[PartitionStore] = None
        # a session built by ``open`` owns the directory's writer handle
        # and one pinned generation view; in-RAM sessions have neither
        self._mdir: Optional[Any] = None
        self._view: Optional[Any] = None
        self._bind(pg)

    def _bind(self, pg: PartitionedGraph) -> None:
        """(Re)build everything that depends on the vertex assignment: the
        store (so no stale single-partition entry or stacked bundle of an
        older layout can be served), the engine, and the per-partition
        profile counters (old pids name different vertex sets)."""
        if self.store is not None:
            # join in-flight read-aheads and drop both cache tiers
            self.store.close()
        self.pg = pg
        self.scheme = pg.scheme
        self.k = pg.k
        self.store = PartitionStore(pg, capacity_parts=self._cache_parts,
                                    capacity_bytes=self._cache_bytes,
                                    backing=self._backing,
                                    host_cache_parts=self._host_cache_parts,
                                    host_cache_bytes=self._host_cache_bytes,
                                    read_ahead=self._read_ahead,
                                    tracer=self.tracer, device=self.device,
                                    profiler=self.profiler)
        if self.engine_name == "opat":
            self.engine = OPATEngine(pg, self.config, store=self.store,
                                     prefetch=self._prefetch, tracer=self.tracer,
                                     profiler=self.profiler)
        elif self.engine_name == "traditional":
            self.engine = TraditionalMPEngine(pg, self._processors, self.config,
                                              store=self.store, tracer=self.tracer,
                                              profiler=self.profiler)
        else:
            self.engine = MapReduceMPEngine(pg, self.config, heuristic=self.heuristic,
                                            store=self.store, tracer=self.tracer,
                                            profiler=self.profiler, mesh=self._mesh)
        # MapReduceMP surfaces per-partition yield counters but has no host
        # partition loop, so no per-partition load sequence: the profile
        # says so rather than passing off zeros as load observations
        self.observes_partition_counters = self.engine_name != "mapreduce"
        self._loads = np.zeros(self.k, dtype=np.int64)
        self._completed = np.zeros(self.k, dtype=np.int64)
        self._spawned = np.zeros(self.k, dtype=np.int64)
        # answer-span observations: how many answer rows bound vertices in
        # both p and q, and how often each vertex was bound in a
        # partition-spanning answer
        self._cospan = np.zeros((self.k, self.k), dtype=np.int64)
        self._vertex_span = np.zeros(self.graph.n_nodes, dtype=np.int64)
        self._span_sum = 0
        self._span_rows = 0
        self._queries_served = 0
        self._answers_served = 0
        # SLO serving accumulators (``record_serving``); the profile has a
        # "serving" block only when they are non-empty
        self._slo_counters: Dict[str, int] = {}
        self._slo_shed_reasons: Dict[str, int] = {}
        self._slo_latencies: Dict[str, List[float]] = {}
        self._slo_deadline: Dict[str, List[int]] = {}
        self._slo_burn: Dict[str, Dict[str, Any]] = {}

    # -- serving -----------------------------------------------------------

    def submit(self, query: Union[Query, DisjunctiveQuery],
               max_answers: Optional[int] = None,
               heuristic: Optional[str] = None,
               seed: Optional[int] = None) -> QueryResult:
        """Serve one query against the session's resident partitions.

        ``max_answers`` is the paper's "specified number of answers" K
        (per disjunct); ``heuristic``/``seed`` default to the session's.
        """
        disjuncts = (query.disjuncts if isinstance(query, DisjunctiveQuery)
                     else [query])
        h = heuristic if heuristic is not None else self.heuristic
        s = seed if seed is not None else self.seed
        stats0 = self.store.stats.copy()
        t0 = time.time()
        reports: List[RunReport] = []
        answers: Optional[np.ndarray] = None
        # the whole call runs under ONE generation view: a mutation or a
        # compaction landing meanwhile never changes what its loads read
        view = self._view
        ctx = (self.store.viewing(view) if view is not None
               else contextlib.nullcontext())
        gen = int(view.generation) if view is not None else None
        with self.tracer.span("query", query=query.name, heuristic=h,
                              engine=self.engine_name, generation=gen) as qsp, ctx:
            for q in disjuncts:
                plan = generate_plan(q, self.graph, self.catalog)
                rep = self.engine.run_request(RunRequest(
                    plan=plan, heuristic=h, max_answers=max_answers, seed=s))
                reports.append(rep)
                a = rep.answers
                answers = a if answers is None else np.unique(
                    np.concatenate([answers, a]), axis=0)
            qsp.set(n_answers=int(answers.shape[0]),
                    n_loads=sum(len(r.stats.loads) for r in reports))
        latency = time.time() - t0
        for rep in reports:
            rep.stats.generation = gen
        self._absorb(reports, answers)
        return QueryResult(name=query.name, answers=answers, reports=reports,
                           latency_s=latency,
                           load_stats=self.store.stats - stats0,
                           generation=gen)

    def scheduler(self, heuristic: Optional[str] = None,
                  seed: Optional[int] = None,
                  release_retired: bool = False,
                  fairness_gamma: float = 0.0) -> "Any":
        """A ``QueryScheduler`` bound to this session's store, engine and
        catalog (core/scheduler.py) — the multi-query serving loop.
        ``heuristic`` is a *shared* ranking (default MAX-YIELD-SHARED);
        ``fairness_gamma`` weights the anti-starvation aging term.  Prefer
        ``submit_many`` unless you need streaming admission: only
        ``submit_many`` feeds results into the session's counters."""
        from .heuristics import MAX_YIELD_SHARED
        from .scheduler import QueryScheduler
        return QueryScheduler(
            self,
            heuristic=heuristic if heuristic is not None else MAX_YIELD_SHARED,
            seed=seed, release_retired=release_retired,
            fairness_gamma=fairness_gamma)

    def frontend(self, **kwargs) -> "Any":
        """A ``ServingFrontend`` over this session (serving/frontend.py):
        continuous-arrival serving with cost-predicted admission, deadline
        scheduling and load shedding.  Keyword arguments pass through
        (``slo_classes``, ``cost_model``, ``shed_policy``,
        ``replay_speed``, ...).  With no SLO classes it delegates to
        ``submit_many``, with identical results."""
        from ..serving.frontend import ServingFrontend
        return ServingFrontend(self, **kwargs)

    def record_serving(self, *, counters: Dict[str, int],
                       shed_by_reason: Dict[str, int],
                       latencies: Dict[str, List[float]],
                       deadline_met: Dict[str, List[bool]],
                       slo_burn: Optional[Dict[str, Dict[str, Any]]] = None
                       ) -> None:
        """Fold one ``ServingFrontend.serve`` run's admission and shed
        counters and per-class latencies into the profile's ``"serving"``
        block; ``slo_burn`` (the burn monitor's snapshot) is kept latest
        wins."""
        for key, n in counters.items():
            self._slo_counters[key] = self._slo_counters.get(key, 0) + int(n)
        for reason, n in shed_by_reason.items():
            self._slo_shed_reasons[reason] = \
                self._slo_shed_reasons.get(reason, 0) + int(n)
        for cls, vals in latencies.items():
            self._slo_latencies.setdefault(cls, []).extend(
                float(v) for v in vals)
        for cls, oks in deadline_met.items():
            met = self._slo_deadline.setdefault(cls, [0, 0])
            for ok in oks:
                met[0] += int(bool(ok))
                met[1] += 1
        if slo_burn:
            for cls, snap in slo_burn.items():
                self._slo_burn[cls] = dict(snap)

    def submit_many(self, queries: Sequence[Union[Query, DisjunctiveQuery]],
                    max_answers: Union[None, int,
                                       Sequence[Optional[int]]] = None,
                    heuristic: Optional[str] = None,
                    seed: Optional[int] = None,
                    release_retired: bool = False,
                    fairness_gamma: float = 0.0) -> "Any":
        """Serve a batch of queries through the shared-load scheduler and
        return its ``ScheduleReport`` (``.results`` holds one
        ``QueryResult`` per query, in input order).  ``max_answers`` is one
        per-disjunct budget K for the whole batch, or a per-query sequence
        of budgets (None entries = exhaustive).

        Answers match a loop of ``submit`` calls when exhaustive, with the
        same per-disjunct budget K, and every result is absorbed into the
        session's counters as single submits are; but the partition-load
        sequence is chosen at the *workload* level, so overlapping queries
        share loads, and each ``QueryResult.load_stats`` reports the loads
        that query took part in."""
        if isinstance(max_answers, (list, tuple)):
            budgets = list(max_answers)
            if len(budgets) != len(queries):
                raise ValueError(f"got {len(budgets)} budgets for "
                                 f"{len(queries)} queries")
        else:
            budgets = [max_answers] * len(queries)
        sched = self.scheduler(heuristic=heuristic, seed=seed,
                               release_retired=release_retired,
                               fairness_gamma=fairness_gamma)
        try:
            for q, b in zip(queries, budgets):
                sched.admit(q, max_answers=b)
            report = sched.run()
        finally:
            sched.close()   # drop the scheduler's generation pin
        for res in report.results:
            self._absorb(res.reports, res.answers)
        return report

    def _absorb(self, reports: List[RunReport], answers: np.ndarray) -> None:
        """Fold one served query into the session's counters (loads per
        partition, the yield counters, the answers' co-span); traced as
        ``session.absorb``."""
        with self.tracer.span("session.absorb") as sp:
            if self.tracer.enabled:
                sp.set(answers=int(answers.shape[0]))
            for rep in reports:
                for pid in rep.stats.loads:
                    self._loads[pid] += 1
                st = rep.extra.get("state")
                if st is not None:
                    self._completed += st.completed_from
                    self._spawned += st.spawned_from
                elif rep.extra.get("completed_from") is not None:
                    # MapReduceMP: the lanes' yield counters as [k] arrays
                    self._completed += rep.extra["completed_from"]
                    self._spawned += rep.extra["spawned_from"]
            pairs, span = answer_span_matrix(self.pg.owner, answers, self.k)
            self._cospan += pairs
            spanning = answers[span >= 2]
            if spanning.size:
                ids = spanning[spanning >= 0]
                np.add.at(self._vertex_span, ids, 1)
            self._span_sum += int(span.sum())
            self._span_rows += int(span.shape[0])
            self._queries_served += 1
            self._answers_served += int(answers.shape[0])

    # -- observability -----------------------------------------------------

    @property
    def load_stats(self) -> LoadStats:
        """Lifetime store counters (cold/warm/evictions/prefetch)."""
        return self.store.stats

    def workload_profile(self) -> Dict[str, Any]:
        """Per-partition load/yield/completion-rate profile of everything
        this session served, the answer-span (co-traversal) matrix, and
        the assignment it was observed under: what ``serve --json``
        embeds and what repartitioning consumes.
        ``partition_counters_observed`` is False for MapReduceMP (yield
        counters, but no per-partition load sequence).  A mutable session
        adds each partition's pending ``delta_count`` and the
        ``generation``, ``pending_deltas`` and ``compactions``; one served
        through the SLO front end adds a ``"serving"`` block."""
        pending = (self._mdir.pending_counts()
                   if self._mdir is not None else None)
        partitions = []
        for p in range(self.k):
            comp = int(self._completed[p])
            spawn = int(self._spawned[p])
            entry = {
                "pid": p,
                "loads": int(self._loads[p]),
                "completed": comp,
                "spawned": spawn,
                # Laplace-smoothed, matching heuristics.MAX_YIELD
                "completion_rate": (comp + 1.0) / (comp + spawn + 2.0),
            }
            if pending is not None:
                entry["delta_count"] = int(pending[p])
            partitions.append(entry)
        profile: Dict[str, Any] = {
            "engine": self.engine_name,
            "scheme": self.scheme,
            "k": self.k,
            "heuristic": self.heuristic,
            "partition_counters_observed": self.observes_partition_counters,
            "queries_served": self._queries_served,
            "answers_served": self._answers_served,
            "partitions": partitions,
            "answer_spans": {
                "answers_observed": self._span_rows,
                "mean_span": (self._span_sum / self._span_rows
                              if self._span_rows else 0.0),
                "pair_counts": self._cospan.tolist(),
                "vertex_span_counts": self._vertex_span.tolist(),
            },
            "assignment": self.pg.assignment.astype(int).tolist(),
            "out_of_core": self.out_of_core,
            "cache": self.store.stats.to_dict(),
        }
        if self._mdir is not None:
            profile["generation"] = int(self._view.generation)
            profile["pending_deltas"] = int(sum(pending))
            profile["compactions"] = int(self._mdir.compactions)
        if self._slo_counters or self._slo_latencies:
            def _pct(vals: List[float], q: float) -> float:
                return float(np.percentile(np.asarray(vals), q * 100.0)) \
                    if vals else 0.0
            profile["serving"] = {
                "counters": dict(sorted(self._slo_counters.items())),
                "shed_by_reason": dict(sorted(self._slo_shed_reasons.items())),
                "classes": {
                    cls: {
                        "served": len(vals),
                        "p50_latency_s": _pct(vals, 0.5),
                        "p95_latency_s": _pct(vals, 0.95),
                        "p99_latency_s": _pct(vals, 0.99),
                        "deadline_met": self._slo_deadline.get(cls, [0, 0])[0],
                        "deadline_total": self._slo_deadline.get(cls, [0, 0])[1],
                    }
                    for cls, vals in sorted(self._slo_latencies.items())
                },
            }
        return profile

    def save_profile(self, path: str) -> None:
        """Persist ``workload_profile()`` as JSON."""
        with open(path, "w") as f:
            json.dump(self.workload_profile(), f, indent=2)

    # -- out-of-core storage (storage/) ------------------------------------

    @property
    def out_of_core(self) -> bool:
        """True while partitions are disk-resident (a session built by
        ``open``; ``repartition()`` moves it back in RAM until the new
        layout is ``save``d)."""
        return self._backing is not None

    def save(self, path: str) -> Dict[str, Any]:
        """Write this session's partitioned graph as a *graph directory*
        (storage/format.py: ``manifest.json`` + one content-addressed
        shard per partition + the whole-graph arrays); returns the
        manifest.  Works for in-RAM and disk-opened sessions alike (the
        latter streams shards one at a time); the manifest is written
        last, so an interrupted save never yields an openable directory."""
        from ..storage.format import save_partitioned_graph
        return save_partitioned_graph(self.pg, path)

    @classmethod
    def open(cls, path: str, *,
             engine: str = "opat",
             heuristic: str = MAX_SN,
             config: Optional[EngineConfig] = None,
             cache_parts: Optional[int] = None,
             cache_bytes: Optional[int] = None,
             host_cache_parts: Optional[int] = None,
             host_cache_bytes: Optional[int] = None,
             read_ahead: bool = True,
             processors: int = 2,
             prefetch: bool = True,
             seed: int = 0,
             mesh: Optional[PartMesh] = None,
             verify_checksums: bool = True,
             tracer: Optional[Any] = None,
             device: Union[None, str, torch.device] = None,
             profiler: Optional[Any] = None) -> "GraphSession":
        """Open a ``save``d graph directory as an *out-of-core* session.

        Partition shards stay on disk; the store serves them through a
        three-tier cache — device LRU (``cache_parts``/``cache_bytes``)
        over a pinned-host LRU (``host_cache_parts``/``host_cache_bytes``,
        None = unbounded) over disk — and ``read_ahead`` pulls the
        heuristic's runner-up off disk on a background thread while the
        current partition evaluates.  Heuristic ranking and scheduler
        admission read the manifest, so they never touch a shard.
        Answers equal a session's over the in-RAM graph; only residency
        (and ``LoadStats.disk_reads`` / ``read_ahead_hits``) differs.

        The directory opens *mutable* (storage/deltas.py): the session
        binds a pinned generation view, the updates append durable delta
        records, and ``compact`` / ``fold`` publish new generations;
        in-flight queries keep their pinned view, new submits take the
        latest.
        """
        from ..storage.deltas import open_mutable
        mdir = open_mutable(path, verify_checksums=verify_checksums)
        view = mdir.snapshot()
        sess = cls(pg=view.as_partitioned_graph(), engine=engine,
                   heuristic=heuristic, config=config,
                   cache_parts=cache_parts, cache_bytes=cache_bytes,
                   host_cache_parts=host_cache_parts,
                   host_cache_bytes=host_cache_bytes, read_ahead=read_ahead,
                   processors=processors, prefetch=prefetch, seed=seed,
                   mesh=mesh, tracer=tracer, device=device, profiler=profiler)
        sess._mdir = mdir
        sess._view = view
        # the directory's writes trace into the session's stream
        mdir.tracer = sess.tracer
        return sess

    # -- streaming updates (storage/deltas.py) -----------------------------

    @property
    def mutable(self) -> bool:
        """True when the session owns a writable graph directory."""
        return self._mdir is not None

    @property
    def current_view(self):
        """The session's pinned GenerationView (None: in-RAM session)."""
        return self._view

    @property
    def generation(self) -> Optional[int]:
        """The generation new submits run against (None in RAM)."""
        return int(self._view.generation) if self._view is not None else None

    def _require_mutable(self) -> "Any":
        if self._mdir is None:
            raise RuntimeError(
                "streaming updates need a disk-backed session — build one "
                "with GraphSession.open(path) over a save()d directory")
        return self._mdir

    def snapshot(self):
        """A fresh pinned GenerationView of the latest generation and its
        pending deltas (the caller releases it).  While it stays pinned,
        the files its generation needs survive every compaction's GC."""
        return self._require_mutable().snapshot()

    def _refresh_view(self) -> None:
        """Pin the latest generation and rebind the pg-level state on top
        of the UNCHANGED store: view-qualified cache keys keep an older
        view's entries valid for its pins, and new submits resolve
        against the new view (its owner table, g2l rows and geometry)."""
        mdir = self._mdir
        old = self._view
        self._view = mdir.snapshot()
        if old is not None:
            old.release()
        pg = self._view.as_partitioned_graph()
        self.pg = pg
        self.graph = pg.graph
        self.catalog = build_catalog(self.graph)
        self.engine.pg = pg
        self.store.pg = pg
        self.store.backing = mdir.catalog
        self.store.host_tier.catalog = mdir.catalog
        self._backing = mdir.catalog
        if self._vertex_span.shape[0] < self.graph.n_nodes:
            self._vertex_span = np.concatenate([
                self._vertex_span,
                np.zeros(self.graph.n_nodes - self._vertex_span.shape[0],
                         dtype=np.int64)])

    def mutate(self, ops: Sequence[Dict[str, Any]]) -> List[Any]:
        """Apply a batch of updates durably (each a dict ``{"op":
        "edge_add"|"edge_del"|"vertex_add"|"vertex_del", ...}``, see
        ``MutableGraphDirectory.apply_op``) and advance the view once.
        Returns the appended ``DeltaRecord``s."""
        mdir = self._require_mutable()
        recs = [mdir.apply_op(d) for d in ops]
        self._refresh_view()
        return recs

    def add_edge(self, u: int, v: int, label: str,
                 directed: bool = False) -> "Any":
        rec = self._require_mutable().add_edge(u, v, label, directed=directed)
        self._refresh_view()
        return rec

    def del_edge(self, u: int, v: int, label: str) -> "Any":
        rec = self._require_mutable().del_edge(u, v, label)
        self._refresh_view()
        return rec

    def add_vertex(self, label: str, value: float = float("nan"),
                   pid: Optional[int] = None) -> "Any":
        rec = self._require_mutable().add_vertex(label, value=value, pid=pid)
        self._refresh_view()
        return rec

    def del_vertex(self, gid: int) -> "Any":
        rec = self._require_mutable().del_vertex(gid)
        self._refresh_view()
        return rec

    def compact(self, pid: int) -> int:
        """Fold the pending deltas into partition ``pid``'s shard, publish
        the next generation and advance the view; returns the published
        generation.  Queries pinned to older views keep serving them."""
        gen = self._require_mutable().compact(int(pid))
        self._refresh_view()
        return gen

    def compact_all(self) -> int:
        gen = self._require_mutable().compact_all()
        self._refresh_view()
        return gen

    def compact_hot(self, min_pending: int = 1) -> List[int]:
        """Compact every partition with at least ``min_pending`` pending
        delta records (the mutation soak's maintenance policy); returns
        the pids compacted."""
        mdir = self._require_mutable()
        pending = mdir.pending_counts()
        hot = [p for p in range(self.k) if int(pending[p]) >= min_pending]
        for p in hot:
            mdir.compact(p)
        if hot:
            self._refresh_view()
        return hot

    def fold(self, repartition: bool = False, *,
             seed: Optional[int] = None,
             config: Optional[RepartitionConfig] = None) -> Dict[str, Any]:
        """Fold the overlay into a new full layout on disk and rebind the
        session to it; with ``repartition=True`` the layout comes from
        ``workload_profile()`` (core/repartition.py).  Pinned readers keep
        their files; returns the published manifest."""
        mdir = self._require_mutable()
        if repartition:
            cfg = config if config is not None else RepartitionConfig()
            new_pg = repartition_pg(self.pg, self.workload_profile(),
                                    seed=seed, config=cfg)
            self.repartitions += 1
        else:
            new_pg = build_partitions(
                self.graph, np.asarray(self._view.assignment, dtype=np.int64),
                self.k, scheme=self.scheme)
        manifest = mdir.resave(new_pg)
        old = self._view
        self._view = mdir.snapshot()
        if old is not None:
            old.release()
        self._backing = mdir.catalog
        # a new layout changes what each pid means: rebind the whole stack
        self._bind(self._view.as_partitioned_graph())
        self.graph = self.pg.graph
        self.catalog = build_catalog(self.graph)
        return manifest

    # -- the WawPart loop --------------------------------------------------

    def repartition(self, profile: Optional[Any] = None, *,
                    seed: Optional[int] = None,
                    config: Optional[RepartitionConfig] = None) -> Dict[str, Any]:
        """Re-layout the graph from observed traffic and rebind the session.

        ``profile`` is a ``workload_profile()`` dict or a
        ``save_profile()`` JSON path; None uses everything this session has
        served so far.  The store and engine are rebuilt against the new
        assignment (every cached entry of the old layout is dropped) and
        the profile counters restart from zero.  The graph, catalog,
        engine choice, cache capacities and k are unchanged.  Returns a
        summary: scheme, cut before and after, imbalance after, k, and the
        round (``GraphSession.repartitions``).
        """
        prof = profile if profile is not None else self.workload_profile()
        cfg = config if config is not None else RepartitionConfig()
        before = partition_quality(self.graph, self.pg.assignment, self.k)
        new_pg = repartition_pg(self.pg, prof, seed=seed, config=cfg)
        # a disk-opened session's backing names the OLD layout's shards:
        # drop it, so the fresh store holds the new partitions in RAM (and
        # _bind closes the old store, joining any read-ahead).  The
        # directory on disk is untouched until save() writes the new one.
        # A mutable session moves in RAM too: its view pin is released and
        # further updates raise (fold(repartition=True) re-lays it out on
        # disk instead).
        if self._view is not None:
            self._view.release()
            self._view = None
            self._mdir = None
        self._backing = None
        self._bind(new_pg)
        self.repartitions += 1
        after = partition_quality(self.graph, new_pg.assignment, self.k)
        return {"round": self.repartitions, "k": self.k,
                "scheme": self.scheme,
                "cut_before": before["cut"], "cut_after": after["cut"],
                "imbalance_after": after["imbalance"]}
