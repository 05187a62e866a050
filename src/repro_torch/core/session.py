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
cache tiers with identical answers.  The JAX package opens a directory
as a mutable generation view (its storage/deltas.py); here ``open`` reads
the manifest's generation as it stands, so a directory with no pending
deltas serves the same bytes and counters.  Mutation and the SLO front
end come with later slices.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..obs.trace import NULL_TRACER
from .catalog import Catalog, build_catalog
from .engine import EngineConfig, resolve_device
from .graph import Graph, PartitionedGraph, build_partitions
from .heuristics import MAX_SN
from .mapreduce_mp import MapReduceMPEngine
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
    partitions per iteration) or ``"mapreduce"`` (one lane per partition
    on the one device, the session's ``heuristic`` fixed at construction).
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
                 device: Union[None, str, torch.device] = None):
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
        self.repartitions = 0
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.store: Optional[PartitionStore] = None
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
                                    tracer=self.tracer, device=self.device)
        if self.engine_name == "opat":
            self.engine = OPATEngine(pg, self.config, store=self.store,
                                     prefetch=self._prefetch, tracer=self.tracer)
        elif self.engine_name == "traditional":
            self.engine = TraditionalMPEngine(pg, self._processors, self.config,
                                              store=self.store, tracer=self.tracer)
        else:
            self.engine = MapReduceMPEngine(pg, self.config, heuristic=self.heuristic,
                                            store=self.store, tracer=self.tracer)
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
        gen = self.generation
        with self.tracer.span("query", query=query.name, heuristic=h,
                              engine=self.engine_name, generation=gen) as qsp:
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
        for q, b in zip(queries, budgets):
            sched.admit(q, max_answers=b)
        report = sched.run()
        for res in report.results:
            self._absorb(res.reports, res.answers)
        return report

    def _absorb(self, reports: List[RunReport], answers: np.ndarray) -> None:
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
        counters, but no per-partition load sequence)."""
        partitions = []
        for p in range(self.k):
            comp = int(self._completed[p])
            spawn = int(self._spawned[p])
            partitions.append({
                "pid": p,
                "loads": int(self._loads[p]),
                "completed": comp,
                "spawned": spawn,
                # Laplace-smoothed, matching heuristics.MAX_YIELD
                "completion_rate": (comp + 1.0) / (comp + spawn + 2.0),
            })
        return {
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

    @property
    def mutable(self) -> bool:
        """Graph updates are not ported: no session takes them."""
        return False

    @property
    def generation(self) -> Optional[int]:
        """The opened directory's manifest generation (None in RAM)."""
        return self._backing.generation if self._backing is not None else None

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
             verify_checksums: bool = True,
             tracer: Optional[Any] = None,
             device: Union[None, str, torch.device] = None) -> "GraphSession":
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
        """
        from ..storage.format import open_partitioned_graph
        pg = open_partitioned_graph(path, verify_checksums=verify_checksums)
        return cls(pg=pg, engine=engine, heuristic=heuristic, config=config,
                   cache_parts=cache_parts, cache_bytes=cache_bytes,
                   host_cache_parts=host_cache_parts,
                   host_cache_bytes=host_cache_bytes, read_ahead=read_ahead,
                   processors=processors, prefetch=prefetch, seed=seed,
                   tracer=tracer, device=device)

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
        self._backing = None
        self._bind(new_pg)
        self.repartitions += 1
        after = partition_quality(self.graph, new_pg.assignment, self.k)
        return {"round": self.repartitions, "k": self.k,
                "scheme": self.scheme,
                "cut_before": before["cut"], "cut_after": after["cut"],
                "imbalance_after": after["imbalance"]}
