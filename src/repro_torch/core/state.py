"""Bookkeeping state for partitioned query evaluation (paper Sec. 6).

The paper keeps three kinds of files:

  SNI — Starting Node Information: start labels (vertex id NULL) and
        continuation nodes (vertex id bound) per partition,
  IMA — Intermediate Answers, one per partition: partial bindings whose next
        expansion must happen in that partition,
  FAA — Final All Answers, appended incrementally.

Here those become fixed-capacity array buffers so every engine step is
jittable.  A *binding row* is ``[Q_pad]`` of global vertex ids (-1 unbound)
plus a ``step`` cursor into the plan; a row is an answer when
``step == n_steps`` (the paper demarcates complete answers by size — same
criterion).  Host-side dataclasses wrap the arrays for the OPAT /
TraditionalMP orchestrators; MapReduceMP keeps them device-resident.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .query import OP_EQ, OP_GE, OP_GT, OP_LE, OP_LT, OP_NE, OP_NONE


def apply_value_op(op, values, v):
    """Predicate evaluation; works for numpy and jax arrays (operator
    overloading only).  Nodes without a numeric value (NaN) fail every
    predicate, including !=, matching QP-Subdue semantics."""
    finite = values == values  # NaN-safe isfinite for both backends
    if isinstance(op, (int, np.integer)):
        if op == OP_NONE:
            return finite | True
        if op == OP_EQ:
            return finite & (values == v)
        if op == OP_NE:
            return finite & (values != v)
        if op == OP_LT:
            return finite & (values < v)
        if op == OP_LE:
            return finite & (values <= v)
        if op == OP_GT:
            return finite & (values > v)
        if op == OP_GE:
            return finite & (values >= v)
        raise ValueError(f"bad op {op}")
    # traced op (jax): branchless select over all comparisons
    eq = values == v
    res = (
        (op == OP_NONE)
        | ((op == OP_EQ) & eq)
        | ((op == OP_NE) & (values != v))
        | ((op == OP_LT) & (values < v))
        | ((op == OP_LE) & (values <= v))
        | ((op == OP_GT) & (values > v))
        | ((op == OP_GE) & (values >= v))
    )
    return (finite | (op == OP_NONE)) & res


@dataclasses.dataclass
class BindingBatch:
    """Host-side bag of binding rows (the content of one IMA file)."""

    rows: np.ndarray   # [n, Q_pad] int32
    step: np.ndarray   # [n] int32

    @staticmethod
    def empty(q_pad: int) -> "BindingBatch":
        return BindingBatch(rows=np.zeros((0, q_pad), dtype=np.int32),
                            step=np.zeros((0,), dtype=np.int32))

    @property
    def n(self) -> int:
        return int(self.rows.shape[0])

    def concat(self, other: "BindingBatch") -> "BindingBatch":
        if self.n == 0:
            return other
        if other.n == 0:
            return self
        return BindingBatch(rows=np.concatenate([self.rows, other.rows]),
                            step=np.concatenate([self.step, other.step]))

    def dedup(self) -> "BindingBatch":
        """Drop duplicate (rows, step) entries — an answer prefix re-entering a
        partition along two cut edges must not double-count (paper Fig. 4c)."""
        if self.n == 0:
            return self
        key = np.concatenate([self.rows, self.step[:, None]], axis=1)
        _, idx = np.unique(key, axis=0, return_index=True)
        idx.sort()
        return BindingBatch(rows=self.rows[idx], step=self.step[idx])


@dataclasses.dataclass
class SNIEntry:
    """One SNI record: either a start-label entry (vertex NULL) or a
    continuation count for a partition."""

    pid: int
    fresh_starts: int      # #unconsumed start-label nodes (vertex id NULL)
    continuations: int     # #rows pending in this partition's IMA


@dataclasses.dataclass
class QueryState:
    """SNI + IMA + FAA for one conjunctive plan over k partitions."""

    k: int
    q_pad: int
    ima: List[BindingBatch]            # per-partition intermediate answers
    fresh_pending: np.ndarray          # [k] bool: start nodes not yet seeded
    fresh_counts: np.ndarray           # [k] int64: #start nodes per partition
    faa_rows: List[np.ndarray]         # accumulated answers
    loads: List[int]                   # sequence of partition loads (metric)
    iterations: int = 0
    # per-partition yield observations (MAX-YIELD heuristic): when partition
    # p was processed, how many rows completed an answer vs spawned a
    # continuation into another partition's IMA
    completed_from: np.ndarray = None  # [k] int64
    spawned_from: np.ndarray = None    # [k] int64
    # incrementally-maintained unique answer keys, so the per-load budget
    # check is O(new rows), not a full-FAA np.unique; engines must append
    # answers via add_answers().  None (the default) skips the bookkeeping
    # entirely — exhaustive runs never consult budget_met, so they should
    # not pay the tuple-hashing/memory cost.
    answer_keys: Optional[set] = None

    @staticmethod
    def initial(k: int, q_pad: int, fresh_counts: np.ndarray,
                track_answer_keys: bool = False) -> "QueryState":
        return QueryState(
            k=k, q_pad=q_pad,
            ima=[BindingBatch.empty(q_pad) for _ in range(k)],
            fresh_pending=fresh_counts > 0,
            fresh_counts=fresh_counts.astype(np.int64).copy(),
            faa_rows=[], loads=[], iterations=0,
            completed_from=np.zeros(k, dtype=np.int64),
            spawned_from=np.zeros(k, dtype=np.int64),
            answer_keys=set() if track_answer_keys else None)

    def add_answers(self, rows: np.ndarray) -> None:
        """Append completed rows to the FAA (and the unique-key index when
        an answer budget is being tracked)."""
        self.faa_rows.append(rows)
        if self.answer_keys is not None:
            self.answer_keys.update(map(tuple, rows.tolist()))

    def observe_yield(self, pid: int, completed: int, spawned: int) -> None:
        self.completed_from[pid] += completed
        self.spawned_from[pid] += spawned

    def completion_rates(self) -> dict:
        """Laplace-smoothed completed/(completed+spawned) per partition —
        the MAX-YIELD signal (0.5 prior when nothing was observed yet)."""
        return {p: (float(self.completed_from[p]) + 1.0)
                   / (float(self.completed_from[p] + self.spawned_from[p]) + 2.0)
                for p in range(self.k)}

    def sni_count(self, pid: int) -> int:
        """The SNI-derived score used by the SN heuristics: fresh start nodes
        (if unconsumed) + pending continuation rows."""
        fresh = int(self.fresh_counts[pid]) if self.fresh_pending[pid] else 0
        return fresh + self.ima[pid].n

    def eligible(self) -> List[int]:
        return [p for p in range(self.k)
                if (self.fresh_pending[p] and self.fresh_counts[p] > 0)
                or self.ima[p].n > 0]

    def answers(self) -> np.ndarray:
        if not self.faa_rows:
            return np.zeros((0, self.q_pad), dtype=np.int32)
        return np.concatenate(self.faa_rows, axis=0)

    def unique_answers(self) -> np.ndarray:
        a = self.answers()
        if a.shape[0] == 0:
            return a
        return np.unique(a, axis=0)

    def unique_answer_count(self) -> int:
        if self.answer_keys is not None:
            return len(self.answer_keys)
        return int(self.unique_answers().shape[0])

    def budget_met(self, max_answers) -> bool:
        """True when an answer budget is set and the FAA already holds that
        many unique answers (the engines' early-termination test)."""
        return (max_answers is not None
                and self.unique_answer_count() >= max_answers)
