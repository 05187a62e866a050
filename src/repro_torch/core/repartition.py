"""Answer-span observations a ``GraphSession`` folds into its workload
profile.  Only ``answer_span_matrix`` is needed by the in-RAM OPAT
session; the reweighting and repartitioning loop comes with a later
slice."""
from __future__ import annotations

import numpy as np


def answer_span_matrix(owner: np.ndarray, rows: np.ndarray, k: int
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Per-answer partition spans from bound vertex ids.

    ``rows`` is [n, q_pad] of global vertex ids (-1 = unbound slot);
    returns ``(pair_counts [k, k], span [n])`` where ``pair_counts[p, q]``
    (p != q) counts answer rows binding vertices in both p and q,
    ``pair_counts[p, p]`` counts rows touching p at all, and ``span[i]`` is
    the number of distinct partitions answer i's bindings live in.  This is
    the co-traversal signal ``reweight_edges`` consumes — observed
    host-side from the answers themselves, so it exists for every engine
    (including MapReduceMP, which has no per-partition load counters).
    """
    n = int(rows.shape[0])
    if n == 0:
        return np.zeros((k, k), dtype=np.int64), np.zeros(0, dtype=np.int64)
    mask = rows >= 0
    pids = owner[np.clip(rows, 0, None)]
    present = np.zeros((n, k), dtype=bool)
    ri = np.broadcast_to(np.arange(n)[:, None], rows.shape)
    present[ri[mask], pids[mask]] = True
    pi = present.astype(np.int64)
    return pi.T @ pi, pi.sum(axis=1)
