"""The one traffic generator: every mix is a JSON file of parameters
under ``graphbench/traffic/`` that this module reads.

Keys of a mix:

  arrivals      "poisson": open loop, requests due at a fixed rate over
                the window; "batch": ``batch`` requests due at once,
                served to completion and repeated until the window ends
  rate_qps      (poisson) the offered rate, queries/s: a number fixed in
                the mix, about 0.8 of the knee found for the cell's
                configuration by a sweep on the card
  batch         (batch) requests per batch
  budget_share  share of requests that carry a budget
  budget        that budget, ``max_answers`` per disjunct
  replay_speed  what the front end's ``replay_speed`` is given (1: arrival
                times are wall seconds; 0: all due at once)

The work is fixed by the seed: every seed gets the same number of
requests, the same count of each query template (the configuration's
``queries``, as even as the count allows) and of budgeted requests, and
the same multiset of gaps between arrivals (the exponential
distribution's quantiles at (i + 1/2)/n), in a seed-drawn order.  The
queries' parameters (such as the people an IMDB query asks about) are
drawn from the seed.
"""
from __future__ import annotations

from typing import Iterator, List

import numpy as np


def _mix(rng: np.random.Generator, n: int, templates, share: float,
         budget: int) -> List[tuple]:
    """(template, max_answers) for n requests, shuffled."""
    T = len(templates)
    order = list(rng.permutation(T))
    names = [templates[order[i % T]] for i in range(n)]
    budgets = [None] * n
    for i in rng.choice(n, size=int(round(n * share)), replace=False):
        budgets[int(i)] = int(budget)
    perm = rng.permutation(n)
    return [(names[i], budgets[i]) for i in perm]


def poisson_requests(traffic: dict, cfg: dict, gen, g, seed: int,
                     seconds: float) -> List[dict]:
    """The open-loop window: round(rate x seconds) requests, the first due
    at 0 and the last before ``seconds``."""
    rate = float(traffic["rate_qps"])
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([int(seed), 10])
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = gaps * (seconds / gaps.sum())
    arrival = np.concatenate([[0.0], np.cumsum(rng.permutation(gaps))[:-1]])
    out = []
    for t, (name, k) in zip(arrival, _mix(rng, n, cfg["queries"],
                                          traffic["budget_share"], traffic["budget"])):
        out.append({"query": gen.make_query(g, cfg, name, rng),
                    "max_answers": k, "arrival_s": float(t)})
    return out


def batches(traffic: dict, cfg: dict, gen, g, seed: int) -> Iterator[List[dict]]:
    """Batches of ``batch`` requests, all due at once, without end."""
    rng = np.random.default_rng([int(seed), 11])
    B = int(traffic["batch"])
    while True:
        yield [{"query": gen.make_query(g, cfg, name, rng), "max_answers": k,
                "arrival_s": 0.0}
               for name, k in _mix(rng, B, cfg["queries"],
                                   traffic["budget_share"], traffic["budget"])]


def warmup_requests(traffic: dict, cfg: dict, gen, g, seed: int) -> List[dict]:
    """Set-up's requests: one of each template and one budgeted, due at
    once; under batch traffic one whole batch, so the lanes a window's
    launch carries are warm too."""
    rng = np.random.default_rng([int(seed), 12])
    if traffic["arrivals"] == "batch":
        return next(batches(traffic, cfg, gen, g, int(seed) + 1))
    reqs = [{"query": gen.make_query(g, cfg, name, rng), "max_answers": None,
             "arrival_s": 0.0} for name in cfg["queries"]]
    reqs.append({"query": gen.make_query(g, cfg, cfg["queries"][0], rng),
                 "max_answers": int(traffic["budget"]), "arrival_s": 0.0})
    return reqs
