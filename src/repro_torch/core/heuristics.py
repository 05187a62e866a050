"""Partition-choice heuristics (paper Sec. 5, plus budget/workload-aware).

MAX-SN   : load the eligible partition with the most start/continuation
           nodes (greedy; the paper's best performer).
MIN-SN   : load the eligible partition with the fewest, accumulating
           spanning work into big-SN partitions hoping to process them once.
RANDOM   : baseline — uniform choice among eligible partitions.
MAX-YIELD: budget-aware (answer-budget runs, ``max_answers=K``): rank by
           SNI count x the partition's *observed completion rate* — the
           fraction of rows processed there so far that completed an
           answer rather than spawning a continuation (Laplace-smoothed,
           so unseen partitions score on SNI alone like MAX-SN).  Under a
           small K this prefers partitions likely to FINISH answers over
           ones that merely fan out spanning work; with no observations or
           K=inf it degrades gracefully toward MAX-SN.

MAX-YIELD-SHARED generalizes the per-query ranking to a *workload*: the
``QueryScheduler`` (core/scheduler.py) has many queries pending at once,
and one device-resident partition can advance all of them.
``rank_partitions_shared`` therefore scores each candidate partition by
the total expected yield summed over every pending query that needs it —
Σ_q SNI_q(p) × completion_rate_q(p) — so one cold load services many
queries.  Summing plain SNI (heuristic MAX-SN) is the throughput-greedy
variant with no yield signal.

Ties are resolved randomly, as in the paper.  The same functions order the
top-p set for TraditionalMP / MapReduceMP (Sec. 8.1 line 4/13).
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np

MAX_SN = "max-sn"
MIN_SN = "min-sn"
RANDOM_SN = "random-sn"
MAX_YIELD = "max-yield"
MAX_YIELD_SHARED = "max-yield-shared"
ALL_HEURISTICS = (MAX_SN, MIN_SN, RANDOM_SN)          # the paper's three
BUDGET_HEURISTICS = (MAX_SN, MIN_SN, MAX_YIELD)       # the K-sweep set
SHARED_HEURISTICS = (MAX_SN, MAX_YIELD_SHARED)        # workload-level ranking


def rank_partitions(heuristic: str, eligible: Sequence[int],
                    sni_counts: Sequence[int], rng: np.random.Generator,
                    completion_rates: Optional[Mapping[int, float]] = None,
                    tracer=None) -> List[int]:
    """Return ``eligible`` ordered best-first under ``heuristic``.

    ``completion_rates`` maps pid -> observed completed/(completed+spawned)
    rate in [0, 1]; only MAX-YIELD reads it (missing -> 0.5, the smoothed
    no-information prior).

    An enabled ``tracer`` (obs/trace.py) records one *decision record* per
    call: the per-partition score breakdown (SNI term, completion-rate
    term, final score) plus the chosen pid and ranked order, so
    ``tools/trace_report.py`` can replay why P3 was loaded before P1.
    The untraced path computes nothing extra.
    """
    elig = list(eligible)
    if not elig:
        return []
    if heuristic == RANDOM_SN:
        order = list(rng.permutation(len(elig)))
        ranked = [elig[i] for i in order]
        if tracer is not None and tracer.enabled:
            tracer.decision(
                "heuristic.rank", heuristic=heuristic, chosen=ranked[0],
                ranked=ranked,
                breakdown={int(p): {"sni": int(sni_counts[p]), "score": 0.0}
                           for p in elig})
        return ranked
    counts = np.asarray([sni_counts[p] for p in elig], dtype=np.int64)
    tie = rng.permutation(len(elig))  # random tie-break
    rates = None
    if heuristic == MAX_SN:
        keys = list(zip(-counts, tie))
    elif heuristic == MIN_SN:
        keys = list(zip(counts, tie))
    elif heuristic == MAX_YIELD:
        rates = np.asarray(
            [0.5 if completion_rates is None
             else float(completion_rates.get(p, 0.5)) for p in elig])
        # expected completions if loaded now ~ SNI x completion rate
        keys = list(zip(-(counts * rates), tie))
    else:
        raise ValueError(f"unknown heuristic {heuristic!r}")
    order = sorted(range(len(elig)),
                   key=lambda i: (float(keys[i][0]), int(keys[i][1])))
    ranked = [elig[i] for i in order]
    if tracer is not None and tracer.enabled:
        breakdown = {}
        for i, p in enumerate(elig):
            entry = {"sni": int(counts[i]),
                     # sort keys negate "bigger is better" scores; expose
                     # the natural orientation (argmax(score) == chosen)
                     "score": float(-keys[i][0]) if heuristic != MIN_SN
                     else float(-counts[i])}
            if rates is not None:
                entry["completion_rate"] = float(rates[i])
            breakdown[int(p)] = entry
        tracer.decision("heuristic.rank", heuristic=heuristic,
                        chosen=ranked[0], ranked=ranked,
                        breakdown=breakdown)
    return ranked


def choose_partition(heuristic: str, eligible: Sequence[int],
                     sni_counts: Sequence[int], rng: np.random.Generator,
                     completion_rates: Optional[Mapping[int, float]] = None,
                     tracer=None) -> int:
    return rank_partitions(heuristic, eligible, sni_counts, rng,
                           completion_rates, tracer=tracer)[0]


def choose_top_p(heuristic: str, eligible: Sequence[int],
                 sni_counts: Sequence[int], p: int,
                 rng: np.random.Generator,
                 completion_rates: Optional[Mapping[int, float]] = None,
                 tracer=None) -> List[int]:
    return rank_partitions(heuristic, eligible, sni_counts, rng,
                           completion_rates, tracer=tracer)[:p]


def rank_partitions_shared(heuristic: str,
                           waiting: Mapping[int, Sequence[Tuple]],
                           rng: np.random.Generator,
                           fairness_gamma: float = 0.0,
                           tracer=None) -> List[int]:
    """Workload-level ranking: order candidate partitions best-first by the
    total expected yield over every pending query waiting on them.

    ``waiting`` maps pid -> the per-waiting-query ``(sni_count,
    completion_rate)``, ``(sni_count, completion_rate, rounds_waiting)``,
    or ``(sni_count, completion_rate, rounds_waiting, urgency)``
    observations for that partition (one tuple per query whose SNI/IMA
    makes the partition eligible).  Base scores:

      MAX-SN           : Σ_q sni_q(p)            — most shared pending work
      MAX-YIELD-SHARED : Σ_q sni_q(p) × rate_q(p) — most expected completed
                         answers across the workload (rates are the same
                         Laplace-smoothed per-query observations MAX-YIELD
                         uses, so a fresh workload degrades to MAX-SN/2)

    Fairness under skew: a query whose partitions nobody shares has a
    yield that never dominates a hot partition's, so pure yield ranking
    can starve it for as long as hot traffic keeps arriving.  With
    ``fairness_gamma > 0`` every waiter contributes an *aging* term
    ``gamma × sni_q(p) × rounds_waiting_q`` on top of the base score —
    linear in how many scheduler rounds the query has been passed over —
    so any starving query's partition eventually outranks every bounded
    hot score and is guaranteed service within
    ``O(max_hot_score / (gamma × sni))`` rounds.  ``gamma = 0`` (the
    default) is exactly the pure-yield ranking.

    Deadline awareness: the SLO serving front end (serving/frontend.py)
    attaches a per-query *urgency* — its slack-weighted deadline pressure
    — as the observation's fourth element.  Every waiter then contributes
    ``sni_q(p) × urgency_q`` on top of the base score, so partitions that
    advance deadline-critical queries outrank hotter but slack-rich work.
    All-zero (or absent) urgencies leave every score bit-identical to the
    plain ranking, keeping non-SLO serving byte-for-byte unchanged.

    Ties are resolved randomly, matching ``rank_partitions``.
    """
    pids = sorted(waiting)
    if not pids:
        return []

    def age_of(obs: Tuple) -> float:
        return float(obs[2]) if len(obs) > 2 else 0.0

    if heuristic == MAX_SN:
        base = [float(sum(obs[0] for obs in waiting[p])) for p in pids]
    elif heuristic == MAX_YIELD_SHARED:
        base = [float(sum(obs[0] * obs[1] for obs in waiting[p]))
                for p in pids]
    else:
        raise ValueError(f"unknown shared heuristic {heuristic!r} "
                         f"(one of {SHARED_HEURISTICS})")
    scores = list(base)
    fairness = [0.0] * len(pids)
    if fairness_gamma:
        fairness = [fairness_gamma * sum(obs[0] * age_of(obs)
                                         for obs in waiting[p])
                    for p in pids]
        scores = [s + f for s, f in zip(scores, fairness)]
    urgency = [sum(obs[0] * (float(obs[3]) if len(obs) > 3 else 0.0)
                   for obs in waiting[p]) for p in pids]
    if any(urgency):
        scores = [s + u for s, u in zip(scores, urgency)]
    else:
        urgency = [0.0] * len(pids)
    tie = rng.permutation(len(pids))
    order = sorted(range(len(pids)), key=lambda i: (-scores[i], int(tie[i])))
    ranked = [pids[i] for i in order]
    if tracer is not None and tracer.enabled:
        tracer.decision(
            "heuristic.rank_shared", heuristic=heuristic,
            fairness_gamma=float(fairness_gamma),
            chosen=ranked[0], ranked=ranked,
            breakdown={int(p): {
                "sni": int(sum(obs[0] for obs in waiting[p])),
                "waiters": len(waiting[p]),
                "base": base[i],
                "fairness": fairness[i],
                "urgency": urgency[i],
                "score": scores[i],
            } for i, p in enumerate(pids)})
    return ranked
