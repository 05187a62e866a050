"""The comparison that decides ``correct``, and its control.

Every request due in the window is judged once the window has closed:

  * an exhaustive request (no budget) must return exactly the
    reference's answer set;
  * a request with budget K (per disjunct, as the port applies it) must
    return only reference answers, at least min(K, |D_i|) of each
    disjunct D_i's, and at most the sum of those;
  * a request that never returns counts as unserved.

Two numbers are compared, each with the limit 0 (an exact comparison):
``wrong_answer_sets`` and ``unserved_requests``.

The control puts the reference in the program's place with one stated
guarantee broken (``control`` in the configuration): ``values_bf16``
compares vertex values rounded to bfloat16, the precision below the
configuration's float32; ``drop_cut_edges`` loses every answer that
spans a seed-drawn k-way split of the vertices, as an evaluator that
never continues across partitions would.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from .reference.matcher import Matcher, union

LIMITS = {"wrong_answer_sets": 0, "unserved_requests": 0}


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even)."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    out = r.view(np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), out).astype(np.float32)


def control_matcher(g, control: dict, seed: int) -> Matcher:
    kind = control["kind"]
    if kind == "values_bf16":
        return Matcher(g, values=bf16_round(g.node_value))
    if kind == "drop_cut_edges":
        rng = np.random.default_rng([int(seed), 2])
        block = rng.integers(0, int(control["k"]), g.n_nodes)
        return Matcher(g, keep_edge=block[g.edge_src] == block[g.edge_dst])
    raise ValueError(f"unknown control {kind!r}")


class Judge:
    """Reference answers per distinct query, computed once each."""

    def __init__(self, matcher: Matcher):
        self.matcher = matcher
        self._cache: Dict[str, tuple] = {}

    def reference(self, q: dict) -> tuple:
        """(each disjunct's answers, their union, each disjunct's answers
        as a set of row tuples, the union's)."""
        key = json.dumps(q, sort_keys=True)
        got = self._cache.get(key)
        if got is None:
            parts = self.matcher.match(q)
            whole = union(parts)
            got = (parts, whole, [set(map(tuple, p.tolist())) for p in parts],
                   set(map(tuple, whole.tolist())))
            self._cache[key] = got
        return got

    def ok(self, q: dict, budget: Optional[int], rows: np.ndarray) -> bool:
        """Whether the program's answer rows are right for ``q``."""
        parts, whole, part_sets, whole_set = self.reference(q)
        width = whole.shape[1]
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[1] < width:
            return False
        if rows.shape[0] and (rows[:, width:] != -1).any():
            return False
        got = np.unique(rows[:, :width].astype(np.int32), axis=0) \
            if rows.shape[0] else rows[:, :width].astype(np.int32)
        if got.shape[0] != rows.shape[0]:
            return False            # a row returned twice
        if budget is None:
            return got.shape == whole.shape and bool((got == whole).all())
        mine = set(map(tuple, got.tolist()))
        if not mine <= whole_set:
            return False
        need = [min(budget, p.shape[0]) for p in parts]
        if any(len(mine & s) < k for s, k in zip(part_sets, need)):
            return False
        return len(mine) <= sum(need)


def judge(judge_: Judge, requests: Sequence[dict],
          answers: Sequence[Optional[np.ndarray]]) -> Dict[str, int]:
    """Count wrong and unserved requests.  ``requests`` carry ``query``
    and ``max_answers``; ``answers[i]`` is request i's rows, or None when
    it never returned."""
    wrong = unserved = 0
    for r, rows in zip(requests, answers):
        if rows is None:
            unserved += 1
        elif not judge_.ok(r["query"], r["max_answers"], rows):
            wrong += 1
    return {"wrong_answer_sets": wrong, "unserved_requests": unserved}


def control_answers(ctl: Judge, requests: Sequence[dict]) -> List[np.ndarray]:
    """What the control serves in the program's place: each request's
    answers under the broken guarantee, the first K of each disjunct's
    where a budget is set."""
    out = []
    for r in requests:
        parts, whole = ctl.reference(r["query"])[:2]
        k = r["max_answers"]
        if k is None:
            out.append(whole)
        else:
            out.append(union([p[:k] for p in parts]))
    return out


def passed(counts: Dict[str, int]) -> bool:
    return all(counts[name] <= lim for name, lim in LIMITS.items())


def failed(counts: Dict[str, int]) -> int:
    return counts["wrong_answer_sets"] + counts["unserved_requests"]


def verdict(counts: Dict[str, int]) -> Dict[str, dict]:
    """Each compared number beside its limit."""
    return {name: {"value": int(counts[name]), "limit": lim}
            for name, lim in LIMITS.items()}
