"""Unified host-orchestration layer: one API over all three engines.

The paper evaluates three strategies for processing a partitioned graph
query — OPAT, one partition at a time (Sec. 5-7); TraditionalMP, p
partitions in parallel per iteration (Sec. 8, Algorithm 1); and
MapReduceMP, map/reduce-style one-edge expansion with a shuffle (Sec. 9).
Its stated goal is to "obtain all or *specified number of* answers": the
load-ordering heuristics (Sec. 5) exist precisely so a K-answer request
touches as few partitions as possible.  This module is that contract as
code:

  ``RunRequest``   — a plan + heuristic + optional ``max_answers`` (the
                     paper's "specified number of answers", None = all)
  ``RunReport``    — answers (exactly ``min(K, total)`` unique rows when a
                     budget is set), the paper's ``RunStats`` metrics, and
                     engine-specific extras
  ``QueryRunner``  — the protocol all three engines implement via
                     ``run_request``; benchmarks and the serving driver
                     depend only on it

Budget semantics (identical across engines, asserted by
``tests/test_answer_budget.py``):

  * the run stops as soon as K unique answers exist — OPAT checks the FAA
    between partition loads, TraditionalMP after each top-p merge, and
    MapReduceMP folds a global ``psum`` of per-device answer counts into
    its on-device ``lax.while_loop`` stop condition (no host round-trip);
  * the returned rows are a deterministic subset of the exhaustive run's
    answer set (unique rows in lexicographic order, truncated to K);
  * ``RunStats.answers_requested`` records K, and
    ``RunStats.loads_saved_vs_full`` (filled by the benchmark harness)
    records how many partition loads the budget avoided — the paper's
    response-time-vs-scalability trade-off made measurable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Protocol, runtime_checkable

import numpy as np

from .heuristics import MAX_SN
from .metrics import RunStats
from .plan import Plan


@dataclasses.dataclass(frozen=True)
class RunRequest:
    """One query execution request, engine-agnostic."""

    plan: Plan
    heuristic: str = MAX_SN
    max_answers: Optional[int] = None   # None = run to exhaustion
    seed: int = 0

    def __post_init__(self):
        if self.max_answers is not None and self.max_answers < 0:
            raise ValueError(f"max_answers must be >= 0 or None, "
                             f"got {self.max_answers}")


@dataclasses.dataclass
class RunReport:
    """Engine-agnostic result: what serving and benchmarks consume."""

    answers: np.ndarray        # [n, q_pad] unique rows; n == min(K, total)
    stats: RunStats
    engine: str                # "opat" | "traditional" | "mapreduce"
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_answers(self) -> int:
        return int(self.answers.shape[0])


@runtime_checkable
class QueryRunner(Protocol):
    """What every evaluation engine exposes to callers."""

    def run_request(self, req: RunRequest) -> RunReport: ...


def truncate_answers(answers: np.ndarray,
                     max_answers: Optional[int]) -> np.ndarray:
    """Deterministic K-truncation: unique rows are already in lexicographic
    order (np.unique), so given the same found-answer set the same K rows
    are returned; every returned row is an answer the exhaustive run also
    finds."""
    if max_answers is None:
        return answers
    return answers[:max_answers]
