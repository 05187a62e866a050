"""SLO-aware serving front end: admission control, cost prediction,
deadline scheduling, and load shedding over one ``GraphSession``.

A copy of the JAX package's ``serving/frontend.py``, logic unchanged.

The paper frames scalable query serving as managing the trade-off between
response time and resources (Sec. 1): a deployment cannot run every
arriving query to completion and still answer interactive traffic within
its deadline.  This module is that trade-off as a subsystem, one layer
above the ``QueryScheduler`` (core/scheduler.py):

  SLO classes — every request carries an ``slo_class`` (interactive /
      batch / exhaustive by default, each with a latency deadline and a
      strictness ladder: strict classes are never shed, degradable
      classes lose answer budget first, deferrable classes park until
      the backlog drains, sheddable classes are rejected outright).
  admission   — a ``CostModel`` (serving/cost.py) prices each query from
      catalog/manifest statistics BEFORE admission — never touching a
      shard — and the front end compares predicted completion (current
      predicted backlog + the query's own predicted latency) against the
      class deadline.  Over-budget work degrades, defers, or sheds (in
      that order, under the default ``predictive`` policy) with an
      explicit ``shed_reason``; admitted work enters the scheduler.
  deadline scheduling — admitted queries get a slack-weighted *urgency*
      refreshed every pump; ``rank_partitions_shared`` adds
      ``SNI × urgency`` to each partition's score, so partitions
      advancing deadline-critical queries outrank hotter slack-rich
      work.  The loop pumps ``scheduler.run(max_rounds=1)`` so admission
      and urgency updates interleave with serving.
  calibration — every completion's observed latency feeds
      ``CostModel.observe``, so prediction converges while traffic flows.

Determinism: every admission/degrade/shed decision reads PREDICTED
quantities (the cost model and the predicted backlog), never wall-clock
measurements, so a fixed workload + seed always produces the same
outcome set, on either package — tests/test_torch_frontend.py holds the
port's decisions to the JAX package's on that.  Arrival times replay on
a virtual clock (``replay_speed``; the default 0 admits everything
instantly in arrival order).

Byte-identity: with no SLO classes configured the front end delegates to
``GraphSession.submit_many`` — same answers, same partition-load
sequence, same rng consumption.  All-zero urgencies add literal ``+0.0``
to the shared ranking's float scores, so even a mixed deployment's
no-deadline traffic schedules bit-identically.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Mapping, Optional, Sequence, Union

from ..core.plan import generate_plan
from ..core.query import DisjunctiveQuery, Query
from ..obs.profile import SloBurnMonitor
from ..obs.trace import NULL_TRACER
from .cost import CostEstimate, CostModel

# shed_reason vocabulary (explicit, closed — the CI gate greps for these)
SHED_DEADLINE = "deadline-unreachable"
SHED_POLICY = "deadline-policy"

SHED_POLICIES = ("predictive", "deadline", "never")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One service level: a latency deadline plus the degradation ladder.

    ``priority`` orders classes strictest-first (0 = most latency-critical);
    admission charges a query only the predicted backlog of work at its
    own priority or stricter, so batch traffic never causes interactive
    shedding.  ``deadline_s = inf`` means no deadline (urgency 0).
    """

    name: str
    deadline_s: float
    priority: int
    degradable: bool = False        # may shrink max_answers before shedding
    deferrable: bool = False        # may park until the backlog drains
    sheddable: bool = False         # may be rejected outright
    degraded_max_answers: int = 8   # the budget a degraded query drops to


def default_slo_classes() -> List[SLOClass]:
    """The paper's three service shapes: interactive point lookups with a
    tight deadline (strict — never shed, the system degrades everyone
    else first), batch analytics with a loose one (degradable, then
    sheddable), and exhaustive scans with none (deferred to idle)."""
    return [
        SLOClass("interactive", deadline_s=0.5, priority=0),
        SLOClass("batch", deadline_s=5.0, priority=1,
                 degradable=True, sheddable=True),
        SLOClass("exhaustive", deadline_s=math.inf, priority=2,
                 deferrable=True, sheddable=True),
    ]


def parse_slo_spec(spec: str) -> List[SLOClass]:
    """Parse ``"interactive=0.5,batch=5,exhaustive=inf"`` into classes.

    Known names (the defaults') keep their strictness flags with the
    deadline overridden; unknown names become degradable+sheddable with
    priority by position after the known ones.  Order in the spec is
    priority order.
    """
    known = {c.name: c for c in default_slo_classes()}
    classes: List[SLOClass] = []
    for i, part in enumerate(p.strip() for p in spec.split(",") if p.strip()):
        if "=" not in part:
            raise ValueError(f"bad SLO spec entry {part!r} "
                             f"(want name=deadline_seconds)")
        name, _, val = part.partition("=")
        name = name.strip()
        deadline = math.inf if val.strip().lower() in ("inf", "none") \
            else float(val)
        if deadline <= 0:
            raise ValueError(f"deadline for {name!r} must be > 0 (or inf), "
                             f"got {val!r}")
        base = known.get(name)
        if base is not None:
            classes.append(dataclasses.replace(base, deadline_s=deadline,
                                               priority=i))
        else:
            classes.append(SLOClass(name, deadline_s=deadline, priority=i,
                                    degradable=True, sheddable=True))
    if not classes:
        raise ValueError(f"empty SLO spec {spec!r}")
    return classes


@dataclasses.dataclass
class Request:
    """One arriving query: what to run, when it arrives (seconds on the
    workload's virtual clock), and under which SLO class (None = no
    deadline; with no classes configured at all the front end falls back
    to plain ``submit_many``)."""

    query: Union[Query, DisjunctiveQuery]
    slo_class: Optional[str] = None
    arrival_s: float = 0.0
    max_answers: Optional[int] = None


@dataclasses.dataclass
class RequestOutcome:
    """What happened to one request: served (possibly degraded/deferred)
    or shed with an explicit reason — plus both sides of the prediction
    (predicted vs observed latency) for calibration observability."""

    name: str
    slo_class: Optional[str]
    arrival_s: float
    status: str                          # "ok" | "shed"
    shed_reason: Optional[str] = None    # required iff status == "shed"
    degraded: bool = False               # budget shrunk at admission
    deferred: bool = False               # parked until the backlog drained
    max_answers: Optional[int] = None    # effective budget K served under
    predicted_latency_s: float = 0.0
    latency_s: Optional[float] = None    # observed (None when shed)
    deadline_s: float = math.inf
    deadline_met: Optional[bool] = None  # None when shed / no deadline
    finished_round: Optional[int] = None  # pump index completion was seen at
    result: Optional[object] = None      # the QueryResult (None when shed)


@dataclasses.dataclass
class FrontendReport:
    """One ``serve()`` run: per-request outcomes (input order), per-class
    latency percentiles, and the admission/degrade/shed counters."""

    outcomes: List[RequestOutcome]
    per_class: Dict[str, Dict[str, float]]
    counters: Dict[str, int]
    shed_by_reason: Dict[str, int]
    rounds: int
    wall_s: float
    schedule: Optional[object] = None    # plain path: the ScheduleReport
    # per-class error-budget burn over the run's trailing window
    # (obs/profile.SloBurnMonitor.snapshot(); empty on the plain path)
    slo_burn: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)

    @property
    def served(self) -> List[RequestOutcome]:
        return [o for o in self.outcomes if o.status == "ok"]

    @property
    def shed(self) -> List[RequestOutcome]:
        return [o for o in self.outcomes if o.status == "shed"]


def _percentile(vals: Sequence[float], q: float) -> float:
    """numpy-free exact percentile (linear interpolation) — the report
    stays importable without dragging numpy into small consumers."""
    if not vals:
        return 0.0
    s = sorted(vals)
    pos = q * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@dataclasses.dataclass
class _Pending:
    """One admitted (or deferred) request in flight."""

    idx: int                      # index into the outcomes list
    req: Request
    slo: Optional[SLOClass]
    estimate: Optional[CostEstimate]
    max_answers: Optional[int]
    qid: Optional[int] = None     # None while deferred (not yet admitted)
    admitted_round: int = 0
    arrive_wall: float = 0.0


class ServingFrontend:
    """Continuous-arrival serving over one session's ``QueryScheduler``.

    ``slo_classes`` — the deadline ladder (None = ``default_slo_classes``;
    pass ``[]`` for an explicit no-SLO front end).  ``cost_model`` defaults
    to a fresh ``CostModel`` over the session's graph.  ``shed_policy``:

      predictive — degrade (shrink K), then defer, then shed, strictly
                   from predicted backlog vs deadline (default)
      deadline   — shed anything predicted to miss; no degradation
      never      — admit everything (deadline scheduling still applies)

    ``headroom`` scales the deadline budget admission compares against
    (0.8 = keep 20% slack).  ``replay_speed`` scales workload arrival
    times to wall time (2.0 = replay twice as fast; <= 0 = instant, the
    deterministic default).  ``urgency_weight`` scales the slack-weighted
    deadline pressure fed to the shared ranking.  ``burn_window`` /
    ``error_budget`` parameterize the per-class SLO burn-rate monitor
    (obs/profile.SloBurnMonitor): every finite-deadline completion lands
    in a rolling window and burn = miss_fraction / error_budget.
    """

    def __init__(self, session, *,
                 slo_classes: Optional[Sequence[SLOClass]] = None,
                 cost_model: Optional[CostModel] = None,
                 shed_policy: str = "predictive",
                 heuristic: Optional[str] = None,
                 seed: Optional[int] = None,
                 fairness_gamma: float = 0.0,
                 urgency_weight: float = 1.0,
                 headroom: float = 1.0,
                 replay_speed: float = 0.0,
                 burn_window: int = 100,
                 error_budget: float = 0.01):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        if headroom <= 0:
            raise ValueError(f"headroom must be > 0, got {headroom}")
        self.session = session
        self.classes: Dict[str, SLOClass] = {
            c.name: c for c in (default_slo_classes()
                                if slo_classes is None else slo_classes)}
        self.cost_model = cost_model if cost_model is not None \
            else CostModel(session.pg)
        self.shed_policy = shed_policy
        self.heuristic = heuristic
        self.seed = seed
        self.fairness_gamma = float(fairness_gamma)
        self.urgency_weight = float(urgency_weight)
        self.headroom = float(headroom)
        self.replay_speed = float(replay_speed)
        # SLO burn-rate accounting (obs/profile.py): the rolling window of
        # deadline outcomes per class and the error budget the window's
        # miss fraction is charged against
        self.burn_window = int(burn_window)
        self.error_budget = float(error_budget)

    # -- the serving loop ---------------------------------------------------

    def serve(self, requests: Sequence[Request]) -> FrontendReport:
        """Run one workload of requests to completion (admit → pump →
        retire), returning every request's outcome in input order.  Traced
        as one ``frontend.serve`` span, which starts with a clock anchor
        (obs/trace.py)."""
        tracer = getattr(self.session, "tracer", NULL_TRACER)
        with tracer.span("frontend.serve") as sp:
            tracer.anchor()
            if not self.classes or all(r.slo_class is None for r in requests):
                report = self._serve_plain(requests)
            else:
                for r in requests:
                    if r.slo_class is not None and r.slo_class not in self.classes:
                        raise ValueError(
                            f"unknown slo_class {r.slo_class!r} for query "
                            f"{r.query.name!r} (configured: "
                            f"{sorted(self.classes)})")
                report = self._serve_slo(requests)
            if tracer.enabled:
                sp.set(requests=len(requests), rounds=report.rounds)
        return report

    def _serve_plain(self, requests: Sequence[Request]) -> FrontendReport:
        """No SLO anywhere: delegate to ``submit_many`` — answers AND the
        partition-load schedule are byte-identical to calling it directly
        (same scheduler construction, same rng consumption, all-zero
        urgency contributes +0.0 to every ranking score)."""
        t0 = time.time()
        kwargs = {}
        if self.heuristic is not None:
            kwargs["heuristic"] = self.heuristic
        report = self.session.submit_many(
            [r.query for r in requests],
            max_answers=[r.max_answers for r in requests],
            seed=self.seed, fairness_gamma=self.fairness_gamma, **kwargs)
        by_name: Dict[str, List[object]] = {}
        for res in report.results:
            by_name.setdefault(res.name, []).append(res)
        outcomes = []
        for r in requests:
            res = by_name[r.query.name].pop(0)
            outcomes.append(RequestOutcome(
                name=r.query.name, slo_class=None, arrival_s=r.arrival_s,
                status="ok", max_answers=r.max_answers,
                latency_s=res.latency_s, result=res))
        return FrontendReport(
            outcomes=outcomes, per_class={},
            counters={"arrived": len(requests), "admitted": len(requests),
                      "served": len(outcomes)},
            shed_by_reason={}, rounds=0, wall_s=time.time() - t0,
            schedule=report)

    def _serve_slo(self, requests: Sequence[Request]) -> FrontendReport:
        session = self.session
        sched = session.scheduler(heuristic=self.heuristic, seed=self.seed,
                                  fairness_gamma=self.fairness_gamma)
        t0 = time.time()
        speed = self.replay_speed
        # arrival order: (arrival time, input position) — deterministic
        order = sorted(range(len(requests)),
                       key=lambda i: (requests[i].arrival_s, i))
        outcomes: List[Optional[RequestOutcome]] = [None] * len(requests)
        counters = {"arrived": len(requests), "admitted": 0, "served": 0,
                    "degraded": 0, "deferred": 0, "shed": 0}
        shed_by_reason: Dict[str, int] = {}
        in_flight: Dict[int, _Pending] = {}     # qid -> pending
        deferred: List[_Pending] = []
        next_arrival = 0
        rounds = 0
        burn = SloBurnMonitor(window=self.burn_window,
                              error_budget=self.error_budget)

        def vnow() -> float:
            """The virtual workload clock: wall time scaled by the replay
            speed (speed <= 0 = everything is due immediately)."""
            return math.inf if speed <= 0 else (time.time() - t0) * speed

        def backlog_s(priority: int) -> float:
            """Predicted seconds of in-flight work at ``priority`` or
            stricter — what a new arrival queues behind."""
            total = 0.0
            for p in in_flight.values():
                if p.slo is not None and p.slo.priority <= priority \
                        and p.estimate is not None:
                    total += p.estimate.latency_s
            return total

        tracer = getattr(session, "tracer", NULL_TRACER)
        trace_on = tracer.enabled

        def record_decision(outcome: str, r: Request,
                            slo: Optional[SLOClass],
                            est: Optional[CostEstimate],
                            reason: Optional[str] = None,
                            qid: Optional[int] = None) -> None:
            """One decision record per admission verdict: the predicted
            latency, the backlog it queued behind, and the deadline it was
            judged against — everything trace_report needs to replay WHY
            a request was admitted/degraded/deferred/shed."""
            if not trace_on:
                return
            tracer.decision(
                "frontend.admit", query=r.query.name,
                slo_class=slo.name if slo is not None else None,
                outcome=outcome, reason=reason, qid=qid,
                arrival_s=float(r.arrival_s),
                predicted_latency_s=(float(est.latency_s)
                                     if est is not None else None),
                backlog_s=(backlog_s(slo.priority)
                           if slo is not None else 0.0),
                deadline_s=(float(slo.deadline_s)
                            if slo is not None else None),
                headroom=float(self.headroom))

        def admit(pend: _Pending, outcome: str = "admit") -> None:
            r = pend.req
            pend.qid = sched.admit(r.query, max_answers=pend.max_answers)
            pend.admitted_round = rounds
            pend.arrive_wall = t0 + (r.arrival_s / speed if speed > 0 else 0.0)
            in_flight[pend.qid] = pend
            counters["admitted"] += 1
            record_decision(outcome, r, pend.slo, pend.estimate,
                            qid=pend.qid)

        def shed(idx: int, r: Request, slo: SLOClass, est: CostEstimate,
                 reason: str) -> None:
            counters["shed"] += 1
            shed_by_reason[reason] = shed_by_reason.get(reason, 0) + 1
            record_decision("shed", r, slo, est, reason=reason)
            outcomes[idx] = RequestOutcome(
                name=r.query.name, slo_class=slo.name, arrival_s=r.arrival_s,
                status="shed", shed_reason=reason,
                max_answers=r.max_answers,
                predicted_latency_s=est.latency_s, deadline_s=slo.deadline_s)

        def consider(idx: int) -> None:
            """Admission control for one due arrival: predict, then admit /
            degrade / defer / shed under the policy."""
            r = requests[idx]
            slo = self.classes[r.slo_class] if r.slo_class is not None \
                else None
            plans = [generate_plan(q, session.graph, session.catalog)
                     for q in (r.query.disjuncts
                               if isinstance(r.query, DisjunctiveQuery)
                               else [r.query])]
            est = self.cost_model.predict_plans(plans, r.max_answers)
            pend = _Pending(idx=idx, req=r, slo=slo, estimate=est,
                            max_answers=r.max_answers)
            if slo is None or self.shed_policy == "never":
                admit(pend)
                return
            # deferrable classes always yield to the rest of the workload:
            # park whenever anything else is in flight or still due (the
            # drain phase below admits them) — deterministic, since it
            # reads admission state, not timing
            if slo.deferrable and (in_flight or next_arrival < len(order)):
                pend.estimate = est
                deferred.append(pend)
                counters["deferred"] += 1
                record_decision("defer", r, slo, est, reason="deferrable")
                return
            budget = slo.deadline_s * self.headroom
            finish_est = backlog_s(slo.priority) + est.latency_s
            if math.isinf(slo.deadline_s) or finish_est <= budget:
                admit(pend)
                return
            if self.shed_policy == "deadline":
                if slo.sheddable:
                    shed(idx, r, slo, est, SHED_POLICY)
                else:
                    admit(pend)
                return
            # predictive policy: degrade first (shrink the answer budget
            # and re-price), then shed; strict classes admit regardless
            if slo.degradable:
                k2 = slo.degraded_max_answers if r.max_answers is None \
                    else min(r.max_answers, slo.degraded_max_answers)
                est2 = self.cost_model.predict_plans(plans, k2)
                if backlog_s(slo.priority) + est2.latency_s <= budget \
                        or not slo.sheddable:
                    pend.estimate = est2
                    pend.max_answers = k2
                    counters["degraded"] += 1
                    admit(pend, outcome="degrade")
                    outcomes_mark_degraded[pend.qid] = True
                    return
            if slo.sheddable:
                shed(idx, r, slo, est, SHED_DEADLINE)
            else:
                admit(pend)

        outcomes_mark_degraded: Dict[int, bool] = {}

        def refresh_urgency() -> None:
            """Slack-weighted deadline pressure for every in-flight query:
            1/slack, growing as the deadline nears (inf-deadline and
            no-SLO queries stay at exactly 0.0 → ranking unchanged)."""
            now = vnow()
            for qid, p in in_flight.items():
                if p.slo is None or math.isinf(p.slo.deadline_s):
                    continue
                if speed <= 0:
                    # instant replay has no clock; urgency falls out of the
                    # deadline alone, so tighter classes still rank first
                    slack = p.slo.deadline_s
                else:
                    slack = (p.req.arrival_s + p.slo.deadline_s) - now
                u = self.urgency_weight / max(slack, 0.05)
                sched.set_urgency(qid, u)

        def drain_completions(report) -> None:
            for res in report.results:
                p = in_flight.pop(res.qid)
                latency = max(0.0, time.time() - p.arrive_wall)
                if p.estimate is not None:
                    self.cost_model.observe(p.estimate, latency)
                session._absorb(res.reports, res.answers)
                slo = p.slo
                met = None
                if slo is not None and not math.isinf(slo.deadline_s):
                    met = bool(latency <= slo.deadline_s)
                    # only deadline outcomes burn budget: shed requests
                    # never enter the window, inf-deadline classes have
                    # no budget to burn
                    burn.observe(slo.name, met)
                counters["served"] += 1
                outcomes[p.idx] = RequestOutcome(
                    name=p.req.query.name,
                    slo_class=slo.name if slo else None,
                    arrival_s=p.req.arrival_s, status="ok",
                    degraded=bool(outcomes_mark_degraded.get(p.qid)),
                    deferred=p.qid is not None and any(
                        d is p for d in drained_deferred),
                    max_answers=p.max_answers,
                    predicted_latency_s=(p.estimate.latency_s
                                         if p.estimate else 0.0),
                    latency_s=latency,
                    deadline_s=slo.deadline_s if slo else math.inf,
                    deadline_met=met,
                    finished_round=rounds, result=res)

        drained_deferred: List[_Pending] = []
        try:
            while (next_arrival < len(order) or in_flight or deferred):
                # 1) admit every due arrival (instant replay: all of them);
                # next_arrival advances BEFORE consider() so the deferral
                # check reads only strictly-future arrivals
                while next_arrival < len(order):
                    idx = order[next_arrival]
                    if requests[idx].arrival_s <= vnow():
                        next_arrival += 1
                        with tracer.span("frontend.admit"):
                            consider(idx)
                    elif not in_flight and not deferred:
                        # idle: sleep the replay clock forward to the arrival
                        time.sleep(min(0.05, max(
                            0.0, (requests[idx].arrival_s - vnow()) / speed)))
                    else:
                        break
                # 2) drain phase: nothing due and nothing active -> admit the
                # parked exhaustive work (arrival order)
                if not in_flight and next_arrival >= len(order) and deferred:
                    for p in deferred:
                        drained_deferred.append(p)
                        admit(p)
                    deferred.clear()
                if not in_flight:
                    if speed > 0 and next_arrival < len(order):
                        time.sleep(0.001)  # deferred work parked; due soon
                    continue
                # 3) one bounded scheduler pump with fresh urgencies
                refresh_urgency()
                report = sched.run(max_rounds=1)
                rounds += 1
                with tracer.span("frontend.drain") as sp:
                    if trace_on:
                        sp.set(results=len(report.results))
                    drain_completions(report)
        finally:
            # the whole serve run was pinned to one generation view; let
            # a later compaction's GC reclaim it once superseded
            sched.close()

        latencies: Dict[str, List[float]] = {}
        deadline_met: Dict[str, List[bool]] = {}
        for o in outcomes:
            if o is not None and o.status == "ok" and o.slo_class:
                latencies.setdefault(o.slo_class, []).append(o.latency_s)
                if o.deadline_met is not None:
                    deadline_met.setdefault(o.slo_class, []).append(
                        o.deadline_met)
        per_class = {
            cls: {"served": float(len(vals)),
                  "p50_latency_s": _percentile(vals, 0.5),
                  "p95_latency_s": _percentile(vals, 0.95),
                  "p99_latency_s": _percentile(vals, 0.99)}
            for cls, vals in sorted(latencies.items())}
        slo_burn = burn.snapshot()
        session.record_serving(counters=counters,
                               shed_by_reason=shed_by_reason,
                               latencies=latencies,
                               deadline_met=deadline_met,
                               slo_burn=slo_burn)
        return FrontendReport(
            outcomes=[o for o in outcomes if o is not None],
            per_class=per_class, counters=counters,
            shed_by_reason=shed_by_reason, rounds=rounds,
            wall_s=time.time() - t0, slo_burn=slo_burn)


def requests_from_workload(
        lines: Sequence[Mapping], *,
        default_slo: Optional[str] = None,
        default_max_answers: Optional[int] = None) -> List[Request]:
    """Build ``Request``s from parsed workload-JSONL dicts (launch/serve.py
    format: each line is a query dict with optional ``max_answers`` /
    ``arrival_ms`` / ``slo_class`` keys riding alongside)."""
    reqs: List[Request] = []
    for ln in lines:
        budget = ln.get("max_answers", default_max_answers)
        reqs.append(Request(
            query=DisjunctiveQuery.from_json_dict(ln),
            slo_class=ln.get("slo_class", default_slo),
            arrival_s=float(ln.get("arrival_ms", 0.0)) / 1000.0,
            max_answers=None if budget is None else int(budget)))
    return reqs
