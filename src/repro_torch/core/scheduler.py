"""QueryScheduler — shared-load multi-query serving with batched partition
evaluation.

The paper's cost model says response time is dominated by the number and
sequence of partition *loads*.  A serving deployment has many queries
outstanding at once, and one device-resident partition can advance all of
them.  This module is that observation as a subsystem, one layer between
the ``GraphSession`` API and the engines:

  admission    — ``admit()`` expands a (possibly disjunctive) query into
                 per-disjunct *jobs*, each carrying its own plan,
                 ``QueryState`` (SNI/IMA/FAA bookkeeping, identical to the
                 per-query loops) and ``max_answers`` budget.
  the index    — every round the scheduler derives the partition →
                 waiting-jobs index from the jobs' SNI/IMA eligibility;
                 ``rank_partitions_shared`` (core/heuristics.py) scores
                 each candidate by the yield summed over every waiting
                 query, so one cold load services many queries, and the
                 store prefetches the *workload's* runner-up.
  batched eval — OPAT: the loaded partition evaluates the plans of ALL
                 waiting jobs in one call of ``OPATEngine.batched_evaluator()``
                 (one lane per job).  TraditionalMP: one stacked top-p
                 bundle carries every waiting job's inputs, and the lanes
                 (job, chosen partition) that carry work evaluate in one
                 call of ``TraditionalMPEngine.shared_evaluator()``.  Either
                 way one fused-kernel launch per loop iteration serves
                 every lane.
  retirement   — a job retires when its budget is met or nothing is
                 eligible; a query retires when all its jobs have.  With
                 ``release_retired=True`` the scheduler ``release()``s
                 partitions no pending job can currently use (observable
                 via ``LoadStats.released``).

Each job routes its evaluator outputs through the same
``absorb_eval_outputs`` as the one-query-at-a-time loops, so exhaustive
answers are identical to sequential ``GraphSession.submit``.  The JAX
package pads the batch to a power-of-two bucket (``batch_bucket``) only to
keep its jit cache small; here exactly B lanes evaluate, and the bucket
only names the kernel key the resource profiler costs a call under
(``("scheduler.opat", bucket)``, ``("scheduler.tmp", bucket)``), so both
packages report the same keys.

``LoadStats`` attribution is *round-scoped*: ``ScheduleReport.load_stats``
is the store's exact delta over one ``run()``, and each
``QueryResult.load_stats`` is that query's participation view — the sum
of the per-load-event deltas for loads its plans took part in.

MapReduceMP has no host partition loop to share: its jobs drain one
query at a time (``_run_sequential``), with answers, budgets and
per-query ``LoadStats`` deltas identical to sequential ``submit``.

Deadline awareness: ``admit(..., urgency=)`` and ``set_urgency`` carry
the SLO front end's (serving/frontend.py) per-query deadline pressure
into the shared ranking as each observation's fourth element
(``rank_partitions_shared``); all-zero urgencies leave the ranking
unchanged.

Generation pinning (storage/deltas.py): a scheduler takes its own pin on
the session's current view at construction, and every round of every
``run()`` resolves loads, SNI counts and plans against that one
generation (``store.viewing(view)``), even while mutations land and
compactions publish newer ones.  The pin keeps the generation's files out
of GC until ``close()``.  Results carry the pinned generation (None in
RAM, where there is no view).

Profiling: each ``kernel.eval`` span is costed by the session's profiler
(obs/profile.py) under the JAX package's kernel keys.

Tracing (obs/trace.py): ``scheduler.admit`` per admission,
``scheduler.run`` per call of ``run()`` with ``scheduler.retire``,
``scheduler.rank``, ``scheduler.round`` and ``scheduler.collect`` inside
it; in a round, ``kernel.eval`` per evaluator call, stamped with its
``lanes`` and its step launches (``loops``), then ``scheduler.absorb``
over the call's lane outputs.  A traced ``scheduler.round`` also carries
the ``tier`` its load resolved to (``cold``, ``warm`` or ``prefetch``)
and its ``nbytes``.  Attributes are built only when the tracer is
enabled.

Residency: each round drops its store entry once its evaluation is
done, so an entry the store evicts at the round's unpin is not held
through the next round's load.  Under ``cache_parts=1`` the device then
holds at most two partitions: the one being evaluated (pinned) and the
runner-up staged beside it, or, during a cold load, the new partition
and the runner-up it is about to evict.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Set, Union

import numpy as np

from .engine import plan_to_device, ranked_slots, step_shape
from .heuristics import MAX_YIELD_SHARED, SHARED_HEURISTICS, rank_partitions_shared
from .metrics import RunStats, l_ideal_for_plan
from .opat import OPATEngine, absorb_eval_outputs, lane_outputs
from .plan import Plan, PlanArrays, generate_plan
from .query import DisjunctiveQuery, Query
from .runner import RunReport, RunRequest, truncate_answers
from .session import QueryResult
from .state import BindingBatch, QueryState
from .store import LoadStats
from .traditional_mp import TraditionalMPEngine, lane_inputs


def load_tier(event: LoadStats) -> str:
    """The tier one load resolved to, from the store's counters over it."""
    if event.misses:
        return "cold"
    return "prefetch" if event.prefetch_hits else "warm"


def batch_bucket(n: int) -> int:
    """Round a batch size up to the next power of two (the JAX package's
    padded batch shapes; here the profiler's kernel-key bucket)."""
    assert n >= 1
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class _Job:
    """One disjunct of one admitted query: a plan plus the same SNI/IMA/FAA
    bookkeeping state the per-query loops keep."""

    qid: int
    plan: Plan
    plan_arrays: PlanArrays
    state: QueryState
    max_answers: Optional[int]
    retired: bool = False
    load_stats: LoadStats = dataclasses.field(default_factory=LoadStats)
    rounds_waiting: int = 0              # consecutive rounds passed over
                                         # (the fairness aging signal)
    report: Optional[RunReport] = None   # sequential drain: engine-built
    urgency: float = 0.0                 # deadline pressure (SLO front end:
                                         # slack-weighted; 0 = no deadline)


@dataclasses.dataclass
class _Admitted:
    """One admitted query: its jobs plus per-query attribution."""

    qid: int
    name: str
    jobs: List[_Job]
    max_answers: Optional[int]
    load_stats: LoadStats = dataclasses.field(default_factory=LoadStats)
    finished_at: Optional[float] = None
    # perf_counter bounds of the query's life in the scheduler (the
    # tracer's timebase), for one root "query" span per retired query
    admitted_perf: float = 0.0
    finished_perf: Optional[float] = None


@dataclasses.dataclass
class ScheduleReport:
    """What one ``run()`` round produced: per-query results plus the
    workload-level load sequence and the round-scoped store delta."""

    results: List[QueryResult]   # queries finished this round, admit order
    loads: List[int]             # workload-level partition-load sequence
    batch_sizes: List[int]       # jobs advanced per load
    load_stats: LoadStats        # exact store delta over this round
    wall_s: float
    shared: bool                 # True: a shared (batched) path ran

    @property
    def n_loads(self) -> int:
        return len(self.loads)

    @property
    def loads_per_query(self) -> float:
        """Workload loads amortized over the round's queries (one load
        advancing 4 queries counts once here, once per query in each
        ``QueryResult``)."""
        return self.n_loads / len(self.results) if self.results else 0.0


class QueryScheduler:
    """Admits a batch/stream of queries against one ``GraphSession`` and
    serves them with workload-level load ordering.

    ``heuristic`` is a shared ranking (``SHARED_HEURISTICS``:
    ``max-yield-shared`` default, or ``max-sn`` for plain summed SNI).
    ``release_retired`` frees store entries no pending job can use when a
    query retires.  ``fairness_gamma`` weights the aging term
    (rounds-waiting × SNI) in the shared ranking — 0 (default) is pure
    yield (see ``rank_partitions_shared``).
    """

    def __init__(self, session, *, heuristic: str = MAX_YIELD_SHARED,
                 seed: Optional[int] = None,
                 release_retired: bool = False,
                 fairness_gamma: float = 0.0):
        if heuristic not in SHARED_HEURISTICS:
            raise ValueError(f"shared heuristic must be one of "
                             f"{SHARED_HEURISTICS}, got {heuristic!r}")
        if fairness_gamma < 0.0:
            raise ValueError(f"fairness_gamma must be >= 0, "
                             f"got {fairness_gamma}")
        engine = session.engine
        self.session = session
        self.fairness_gamma = float(fairness_gamma)
        self.pg = session.pg
        self.store = session.store
        self.device = session.device
        self.tracer = session.tracer
        self.profiler = session.profiler
        # the generation pin: this scheduler's own pin on the session's
        # current view (None in RAM); plans and SNI counts come from the
        # binding captured here, whatever the session's live view becomes
        self.view = session.current_view
        if self.view is not None:
            self.view.pin()
        self._graph = session.graph
        self._catalog = session.catalog
        self._closed = False
        self.heuristic = heuristic
        self.seed = session.seed if seed is None else seed
        self.release_retired = release_retired
        # OPAT's runner-up staging, generalized to the workload
        self.prefetch = getattr(engine, "prefetch", False)
        # reported queries are pruned after each run(), so a streaming
        # scheduler holds state proportional to the PENDING set
        self._admitted: Dict[int, _Admitted] = {}
        self._next_qid = 0
        self._jobs: List[_Job] = []
        self._touched: Set[int] = set()   # pids the shared loop ever loaded
        self.loads: List[int] = []
        self.batch_sizes: List[int] = []
        # kernel keys this scheduler has called (a key's first call is
        # marked ``first_call`` on its span)
        self._called_keys: Set[tuple] = set()

    # -- admission ---------------------------------------------------------

    def admit(self, query: Union[Query, DisjunctiveQuery],
              max_answers: Optional[int] = None,
              urgency: float = 0.0) -> int:
        """Add a query to the pending set; returns its qid.  ``max_answers``
        is the per-disjunct answer budget K, exactly as in ``submit``.
        ``urgency`` is the SLO front end's deadline pressure: every
        partition the query waits on gains ``SNI × urgency`` in the shared
        ranking (0 changes nothing); ``set_urgency`` refreshes it."""
        self._check_binding()
        cfg = self.session.config
        qid = self._next_qid
        self._next_qid += 1
        disjuncts = (query.disjuncts if isinstance(query, DisjunctiveQuery)
                     else [query])
        jobs: List[_Job] = []
        with self.tracer.span("scheduler.admit") as sp:
            for q in disjuncts:
                plan = generate_plan(q, self._graph, self._catalog)
                assert plan.n_slots <= cfg.q_pad and plan.n_steps <= cfg.s_pad
                counts = self.pg.start_label_counts(plan.start_label,
                                                    plan.start_value_op,
                                                    plan.start_value)
                st = QueryState.initial(self.pg.k, cfg.q_pad, counts,
                                        track_answer_keys=max_answers is not None)
                jobs.append(_Job(
                    qid=qid, plan=plan,
                    plan_arrays=PlanArrays.from_plan(plan, pad_steps=cfg.s_pad),
                    state=st, max_answers=max_answers, urgency=float(urgency)))
            if self.tracer.enabled:
                sp.set(qid=qid, disjuncts=len(disjuncts))
        self._admitted[qid] = _Admitted(qid=qid, name=query.name, jobs=jobs,
                                        max_answers=max_answers,
                                        admitted_perf=time.perf_counter())
        self._jobs.extend(jobs)
        return qid

    def set_urgency(self, qid: int, urgency: float) -> None:
        """Refresh a pending query's deadline pressure (all its jobs); an
        unknown (already reported) qid is ignored."""
        rec = self._admitted.get(qid)
        if rec is not None:
            for j in rec.jobs:
                j.urgency = float(urgency)

    def _check_binding(self) -> None:
        """Refuse to serve after ``GraphSession.repartition()`` / ``fold()``
        rebound the session (a new store and layout: the pending state
        names the old one) or after ``close()`` dropped the pin.
        Mutations and compactions are fine: they keep the store, and the
        scheduler keeps serving its pinned view."""
        if self.session.store is not self.store:
            raise RuntimeError(
                "the session was rebound (repartition()/fold()?) after "
                "this scheduler was created; its pending state names the "
                "old layout — create a fresh scheduler via "
                "GraphSession.scheduler()/submit_many()")
        if self._closed:
            raise RuntimeError("this scheduler was close()d — its "
                               "generation pin is gone; create a fresh one")

    def close(self) -> None:
        """Release the generation pin (idempotent); the next compaction's
        GC may then reclaim a superseded generation's files."""
        if not self._closed:
            self._closed = True
            if self.view is not None:
                self.view.release()

    @property
    def n_pending(self) -> int:
        return sum(1 for j in self._jobs if not j.retired)

    def partition_waiters(self) -> Dict[int, List[int]]:
        """The partition → waiting-qids index: which pending queries each
        partition would advance if loaded now."""
        return {p: sorted({j.qid for j in js})
                for p, js in self._waiters().items()}

    # -- the shared-load loop ----------------------------------------------

    def run(self, max_rounds: Optional[int] = None) -> ScheduleReport:
        """Serve every pending job to retirement and return the round's
        report.  Re-entrant: queries admitted after a ``run()`` are served
        (and reported) by the next one.  ``max_rounds`` bounds this call
        to that many load rounds (whole queries on the sequential drain),
        leaving the rest pending; None drains everything."""
        self._check_binding()
        with self.tracer.span("scheduler.run") as sp:
            t0 = time.time()
            stats0 = self.store.stats.copy()
            loads0, batches0 = len(self.loads), len(self.batch_sizes)
            engine = self.session.engine
            shared = isinstance(engine, (OPATEngine, TraditionalMPEngine))
            # every load of this call resolves against the pinned generation
            ctx = (self.store.viewing(self.view) if self.view is not None
                   else contextlib.nullcontext())
            with ctx:
                if isinstance(engine, OPATEngine):
                    self._run_shared(max_rounds)
                elif isinstance(engine, TraditionalMPEngine):
                    self._run_shared_tmp(max_rounds)
                else:
                    self._run_sequential(max_rounds)
            with self.tracer.span("scheduler.collect") as csp:
                results = self._collect_results(t0)
                if self.tracer.enabled:
                    csp.set(results=len(results))
            report = ScheduleReport(
                results=results,
                loads=self.loads[loads0:],
                batch_sizes=self.batch_sizes[batches0:],
                load_stats=self.store.stats - stats0,
                wall_s=time.time() - t0,
                shared=shared)
            if self.tracer.enabled:
                sp.set(max_rounds=max_rounds, results=len(results))
        return report

    def _ranked(self, waiters: Dict[int, List[_Job]],
                rng: np.random.Generator) -> List[int]:
        """Rank the candidate partitions by every waiter's (SNI,
        completion rate, rounds waiting); a job's rates are computed once
        per round and only when the ranking reads them."""
        with self.tracer.span("scheduler.rank") as sp:
            if self.tracer.enabled:
                sp.set(candidates=len(waiters))
            rates = {}
            if self.heuristic == MAX_YIELD_SHARED:
                for js in waiters.values():
                    for j in js:
                        if id(j) not in rates:
                            rates[id(j)] = j.state.completion_rates()
            scored = {p: [(j.state.sni_count(p),
                           rates[id(j)][p] if rates else 0.0,
                           j.rounds_waiting,
                           j.urgency)
                          for j in js]
                      for p, js in waiters.items()}
            return rank_partitions_shared(self.heuristic, scored, rng,
                                          fairness_gamma=self.fairness_gamma,
                                          tracer=self.tracer)

    def _stacked_plans(self, batch: List[_Job]):
        """The batch's plans stacked on the device, and their n_steps."""
        plans = plan_to_device(PlanArrays.stack([j.plan_arrays for j in batch]),
                               self.device)
        return plans, [j.plan.n_steps for j in batch]

    def _end_round(self, batch: List[_Job], event: LoadStats) -> None:
        """Round-scoped attribution and fairness aging: the load event
        lands once in each participating query's view and each
        participating job's, and every pending job the round did not
        advance has waited one more round."""
        for qid in {j.qid for j in batch}:
            rec = self._admitted[qid]
            rec.load_stats = rec.load_stats + event
        in_batch = {id(j) for j in batch}
        for j in batch:
            j.load_stats = j.load_stats + event
            j.state.iterations += 1
        for j in self._jobs:
            if not j.retired:
                j.rounds_waiting = 0 if id(j) in in_batch else j.rounds_waiting + 1

    def _limit(self) -> int:
        return 64 * self.pg.k * max(1, len(self._jobs))

    def _run_shared(self, max_rounds: Optional[int] = None) -> None:
        engine: OPATEngine = self.session.engine
        beval = engine.batched_evaluator()
        rng = np.random.default_rng(self.seed)
        limit = self._limit()
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            self._retire()
            waiters = self._waiters()
            if not waiters:
                break
            if len(self.loads) >= limit:
                raise RuntimeError("scheduler exceeded max partition loads "
                                   f"({limit}); likely a routing bug")
            ranked = self._ranked(waiters, rng)
            pid = int(ranked[0])
            batch = waiters[pid]
            attrs = (dict(pid=pid, round=rounds, batch=len(batch),
                          qids=sorted({j.qid for j in batch}))
                     if self.tracer.enabled else {})
            with self.tracer.span("scheduler.round", **attrs) as rsp:
                ev0 = self.store.stats.copy()
                entry = self.store.get(pid)
                # the attributable event is the load itself, snapshot
                # BEFORE staging the workload's runner-up
                event = self.store.stats - ev0
                if self.tracer.enabled:
                    rsp.set(tier=load_tier(event), nbytes=entry.nbytes)
                with self.store.pinned(pid):
                    if self.prefetch and len(ranked) > 1:
                        self.store.prefetch(int(ranked[1]))
                    self._eval_batch(beval, entry, pid, batch)
                # the unpin may have evicted it: its memory goes now, not
                # after the next round's load
                del entry
            self.loads.append(pid)
            self.batch_sizes.append(len(batch))
            self._touched.add(pid)
            for j in batch:
                j.state.loads.append(pid)
            self._end_round(batch, event)
            rounds += 1

    def _run_shared_tmp(self, max_rounds: Optional[int] = None) -> None:
        """TraditionalMP shared batching: each round takes the TOP-P set
        of the workload-level ranking and ships ONE stacked bundle through
        the store carrying every waiting job's inputs; the lanes (job,
        chosen partition) that carry work evaluate in one call.  Per-job
        bookkeeping is the per-query TMP loop's (tail-kept cap chunking,
        one chunk per round of the same partition)."""
        engine: TraditionalMPEngine = self.session.engine
        seval = engine.shared_evaluator()
        cfg = self.session.config
        p = engine.p
        rng = np.random.default_rng(self.seed)
        limit = self._limit()
        rounds = 0
        while max_rounds is None or rounds < max_rounds:
            self._retire()
            waiters = self._waiters()
            if not waiters:
                break
            if len(self.loads) >= limit:
                raise RuntimeError("scheduler exceeded max partition loads "
                                   f"({limit}); likely a routing bug")
            ranked = self._ranked(waiters, rng)
            # canonical sorted order + first-pid padding, as the per-query
            # TMP loop: the stacked store key is permutation-invariant
            chosen = sorted(int(q) for q in ranked[:p])
            lanes = sorted([(pid, True) for pid in chosen]
                           + [(chosen[0], False)] * (p - len(chosen)))
            exec_set = [t[0] for t in lanes]
            is_real = [t[1] for t in lanes]
            waiter_ids = {pid: {id(j) for j in js} for pid, js in waiters.items()}
            # the round's batch: every job waiting on ANY chosen partition,
            # in admit order (a job waiting on two chosen partitions rides
            # both lanes, both IMAs drained)
            in_round = {id(j) for pid in chosen for j in waiters[pid]}
            batch = [j for j in self._jobs if not j.retired and id(j) in in_round]
            lane_part: List[int] = []
            lane_job: List[int] = []
            inputs: List[BindingBatch] = []
            seeds: List[bool] = []
            for b, j in enumerate(batch):
                for i, pid in enumerate(exec_set):
                    if not is_real[i] or id(j) not in waiter_ids[pid]:
                        continue
                    bb = j.state.ima[pid]
                    j.state.ima[pid] = BindingBatch.empty(cfg.q_pad)
                    if bb.n > cfg.cap:
                        # tail kept for a later round of the same partition
                        j.state.ima[pid] = BindingBatch(
                            rows=bb.rows[cfg.cap:], step=bb.step[cfg.cap:])
                        bb = BindingBatch(rows=bb.rows[: cfg.cap],
                                          step=bb.step[: cfg.cap])
                    lane_part.append(i)
                    lane_job.append(b)
                    inputs.append(bb)
                    seeds.append(bool(j.state.fresh_pending[pid]))
                    j.state.fresh_pending[pid] = False
            ev0 = self.store.stats.copy()
            tr = self.tracer
            attrs = (dict(pids=chosen, round=rounds, batch=len(batch),
                          qids=sorted({j.qid for j in batch}))
                     if tr.enabled else {})
            with tr.span("scheduler.round", **attrs) as rsp:
                entry = self.store.get_stacked(tuple(exec_set))
                event = self.store.stats - ev0
                if tr.enabled:
                    rsp.set(tier=load_tier(event), nbytes=entry.nbytes)
                key = ("scheduler.tmp", batch_bucket(len(batch)))
                kattrs = (dict(pids=chosen, batch=len(batch), lanes=len(inputs))
                          if tr.enabled else {})
                with tr.span("kernel.eval", **kattrs) as ksp:
                    # costed at the bucket's most lanes: p for each job
                    self._first_call(ksp, key, entry, key[1] * p)
                    loops0 = engine.batched_iters
                    plans, n_steps = self._stacked_plans(batch)
                    res = seval(entry, plans, n_steps, lane_part, lane_job,
                                *lane_inputs(inputs, cfg.cap, cfg.q_pad,
                                             self.device), seeds)
                    outs, landed = lane_outputs(res)
                    loops = engine.batched_iters - loops0
                    if tr.enabled:
                        ksp.set(loops=loops, landed=landed, candidates=ranked_slots(
                            cfg, entry.part, len(inputs), loops))
                    self.profiler.stamp_kernel(ksp, key, loops)
                    self.profiler.sample_device(ksp, self.store)
                del entry
            with tr.span("scheduler.absorb") as asp:
                if tr.enabled:
                    asp.set(lanes=len(outs))
                for i, b, (overflow, *rest) in zip(lane_part, lane_job, outs):
                    j = batch[b]
                    if overflow:
                        raise RuntimeError(
                            f"evaluator buffer overflow on partition "
                            f"{exec_set[i]} (query {j.plan.query.name!r} in a "
                            f"batch of {len(batch)}); raise EngineConfig.cap "
                            f"(currently {cfg.cap})")
                    absorb_eval_outputs(j.state, exec_set[i], self.pg.k, *rest)
            # the stacked bundle is ONE store event; each chosen pid counts
            # one workload load, its batch size the jobs its lane advanced
            self.loads.extend(chosen)
            for pid in chosen:
                self.batch_sizes.append(
                    sum(1 for i in lane_part if exec_set[i] == pid))
            self._touched.update(chosen)
            for i, b in zip(lane_part, lane_job):
                batch[b].state.loads.append(exec_set[i])
            self._end_round(batch, event)
            rounds += 1

    def _first_call(self, span, key: tuple, entry, lanes: int) -> None:
        """Mark the first call of ``key`` on its span and cost the key's
        step launch at ``lanes`` lanes over ``entry``'s geometry."""
        if key in self._called_keys:
            return
        self._called_keys.add(key)
        span.set(first_call=True)
        self.profiler.attribute_kernel(
            key, *step_shape(self.session.config, entry.part, self.store.owner, lanes))

    def _eval_batch(self, beval, entry, pid: int, batch: List[_Job]) -> None:
        """One call advances every waiting job's plan against the loaded
        partition (chunked when an IMA exceeds the row capacity; later
        chunks are inert for jobs already drained)."""
        cfg = self.session.config
        engine = self.session.engine
        tr = self.tracer
        B = len(batch)
        key = ("scheduler.opat", batch_bucket(B))
        plans, n_steps = self._stacked_plans(batch)
        imas: List[BindingBatch] = []
        seed_flags: List[bool] = []
        for j in batch:
            imas.append(j.state.ima[pid])
            j.state.ima[pid] = BindingBatch.empty(cfg.q_pad)
            seed_flags.append(bool(j.state.fresh_pending[pid]))
            j.state.fresh_pending[pid] = False
        n_chunks = max(1, max(-(-bb.n // cfg.cap) for bb in imas))
        for ci in range(n_chunks):
            lo = ci * cfg.cap
            chunks = [BindingBatch(rows=bb.rows[lo:lo + cfg.cap],
                                   step=bb.step[lo:lo + cfg.cap]) for bb in imas]
            sf = [s and ci == 0 for s in seed_flags]
            attrs = dict(pid=pid, batch=B, lanes=B) if tr.enabled else {}
            with tr.span("kernel.eval", **attrs) as ksp:
                # costed at the bucket's most lanes: one for each job
                self._first_call(ksp, key, entry, key[1])
                loops0 = engine.batched_iters
                res = beval(entry.part, entry.g2l, self.store.owner, plans,
                            n_steps, *lane_inputs(chunks, cfg.cap, cfg.q_pad,
                                                  self.device), sf)
                outs, landed = lane_outputs(res)
                loops = engine.batched_iters - loops0
                if tr.enabled:
                    ksp.set(loops=loops, landed=landed, candidates=ranked_slots(
                        cfg, entry.part, B, loops))
                self.profiler.stamp_kernel(ksp, key, loops)
                self.profiler.sample_device(ksp, self.store)
            with tr.span("scheduler.absorb") as asp:
                if tr.enabled:
                    asp.set(lanes=B)
                for j, (overflow, *rest) in zip(batch, outs):
                    if overflow:
                        raise RuntimeError(
                            f"evaluator buffer overflow on partition {pid} "
                            f"(query {j.plan.query.name!r} in a batch of {B}); "
                            f"raise EngineConfig.cap (currently {cfg.cap})")
                    absorb_eval_outputs(j.state, pid, self.pg.k, *rest)

    def _run_sequential(self, max_rounds: Optional[int] = None) -> None:
        """Engines with no host partition loop to share (MapReduceMP) run a
        whole query per call, so their jobs drain one query at a time.
        ``max_rounds`` bounds the number of QUERIES served this call."""
        session = self.session
        served = 0
        # the engine reads its pg at call time: hold it to the pinned
        # binding for the drain, so a mutation landing mid-run cannot mix
        # generations into the run
        engine = session.engine
        prev_pg = engine.pg
        engine.pg = self.pg
        try:
            for rec in self._admitted.values():
                if rec.finished_at is not None:
                    continue
                if max_rounds is not None and served >= max_rounds:
                    break
                served += 1
                ev0 = self.store.stats.copy()
                for j in rec.jobs:
                    jv0 = self.store.stats.copy()
                    rep = engine.run_request(RunRequest(
                        plan=j.plan, heuristic=session.heuristic,
                        max_answers=j.max_answers, seed=self.seed))
                    j.retired = True
                    j.report = rep
                    j.load_stats = j.load_stats + (self.store.stats - jv0)
                    self.loads.extend(rep.stats.loads)
                    self.batch_sizes.extend([1] * len(rep.stats.loads))
                rec.load_stats = rec.load_stats + (self.store.stats - ev0)
                rec.finished_at = time.time()
                rec.finished_perf = time.perf_counter()
        finally:
            engine.pg = prev_pg

    # -- retirement and the waiter index -----------------------------------

    def _waiters(self) -> Dict[int, List[_Job]]:
        w: Dict[int, List[_Job]] = {}
        for j in self._jobs:
            if j.retired:
                continue
            for p in j.state.eligible():
                w.setdefault(int(p), []).append(j)
        return w

    def _retire(self) -> None:
        """Retire jobs whose budget is met or whose SNI/IMA are exhausted,
        stamp queries whose last job retired, and (optionally) release
        store entries no pending job can currently use."""
        with self.tracer.span("scheduler.retire") as sp:
            now = time.time()
            newly: List[_Job] = []
            for j in self._jobs:
                if j.retired:
                    continue
                if j.state.budget_met(j.max_answers) or not j.state.eligible():
                    j.retired = True
                    newly.append(j)
            for rec in self._admitted.values():
                if rec.finished_at is None and all(j.retired for j in rec.jobs):
                    rec.finished_at = now
                    rec.finished_perf = time.perf_counter()
            if newly and self.release_retired:
                # any partition the workload loaded that no pending job can use
                # now is releasable (prefetched-but-never-loaded entries are
                # left to the LRU)
                needed: Set[int] = set()
                for j in self._jobs:
                    if not j.retired:
                        needed.update(int(p) for p in j.state.eligible())
                for pid in sorted(self._touched - needed):
                    if self.store.contains(pid):
                        self.store.release(pid)
            if self.tracer.enabled:
                sp.set(retired=len(newly))

    # -- results -----------------------------------------------------------

    def _collect_results(self, t0: float) -> List[QueryResult]:
        """Build the finished queries' results (admit order) and prune
        their state."""
        gen = int(self.view.generation) if self.view is not None else None
        results: List[QueryResult] = []
        done: List[int] = []
        for rec in self._admitted.values():
            if rec.finished_at is None:
                continue
            done.append(rec.qid)
            reports: List[RunReport] = []
            answers: Optional[np.ndarray] = None
            for j in rec.jobs:
                rep = j.report
                if rep is None:          # shared path: build from job state
                    a = truncate_answers(j.state.unique_answers(), j.max_answers)
                    delta = j.load_stats
                    rep = RunReport(
                        answers=a,
                        stats=RunStats(
                            query=j.plan.query.name, scheme=self.pg.scheme,
                            heuristic=self.heuristic,
                            loads=list(j.state.loads),
                            l_ideal=l_ideal_for_plan(self.pg, j.plan),
                            n_answers=int(a.shape[0]),
                            iterations=j.state.iterations,
                            answers_requested=j.max_answers,
                            cold_loads=delta.cold_loads,
                            warm_loads=delta.warm_loads,
                            prefetch_hits=delta.prefetch_hits,
                            disk_reads=delta.disk_reads,
                            read_ahead_hits=delta.read_ahead_hits,
                            bytes_cold=delta.bytes_cold,
                            bytes_prefetched=delta.bytes_prefetched,
                            bytes_disk=delta.bytes_disk,
                            bytes_host=delta.bytes_host),
                        engine=self.session.engine_name,
                        extra={"state": j.state})
                rep.stats.generation = gen
                reports.append(rep)
                a = rep.answers
                answers = a if answers is None else np.unique(
                    np.concatenate([answers, a]), axis=0)
            results.append(QueryResult(
                name=rec.name, answers=answers, reports=reports,
                latency_s=max(0.0, rec.finished_at - t0),
                load_stats=rec.load_stats, qid=rec.qid, generation=gen))
            if self.tracer.enabled and rec.finished_perf is not None:
                # one root span per retired query, admission → retirement
                self.tracer.add_span(
                    "query", rec.admitted_perf, rec.finished_perf,
                    qid=rec.qid, query=rec.name, generation=gen,
                    n_answers=int(answers.shape[0]),
                    n_loads=sum(len(r.stats.loads) for r in reports))
        for qid in done:
            del self._admitted[qid]
        self._jobs = [j for j in self._jobs if not j.retired]
        return results
