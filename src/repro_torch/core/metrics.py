"""Quantitative measures for evaluating the heuristics (paper Sec. 5.3).

  load ratio          = L_ideal / AL_h            (<= 1; higher is better)
  h(D)^{query}_{pschemes} = mean load ratio of one query across schemes
  h(D)^{pscheme}_{qbatch} = mean load ratio of a query batch on one scheme

L_ideal is the number of *required* partitions — the paper's Sec. 1
definition: "A required partition is one in which one or more of the query
plan node exists", i.e. partitions containing at least one node matching
ANY query-node predicate (wildcard nodes make every non-empty partition
required).  The paper notes this static count is the usable proxy for the
run-time-only exact bound; the ratio is clipped at 1 ("this value is at
best 1") since no-answer queries can terminate before touching every
required partition.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .graph import PartitionedGraph
from .plan import Plan


@dataclasses.dataclass
class RunStats:
    """Per-(query, scheme, heuristic) execution record."""

    query: str
    scheme: str
    heuristic: str
    loads: List[int]                  # sequence of partition loads
    l_ideal: int
    n_answers: int
    iterations: int = 0               # MP engines: #parallel iterations
    answers_requested: Optional[int] = None   # K of an answer-budget run
    loads_saved_vs_full: Optional[int] = None # full-run loads minus this
                                              # run's (benchmark-filled)
    # PartitionStore residency accounting for this run (core/store.py):
    # a cold load paid a host->device transfer on the critical path, a warm
    # load reused device-resident buffers, a prefetch hit was a transfer
    # that overlapped the previous partition's evaluation.  None when the
    # engine ran without a store (never, since PR 2 — kept Optional so
    # hand-built RunStats in tests/benchmarks stay valid).
    cold_loads: Optional[int] = None
    warm_loads: Optional[int] = None
    prefetch_hits: Optional[int] = None
    # out-of-core (disk-backed) residency for this run: shard reads the
    # store's host tier issued against disk, and how many host gets were
    # served by a background read-ahead instead of a blocking demand read.
    # Zero for in-RAM sessions; None on hand-built RunStats.
    disk_reads: Optional[int] = None
    read_ahead_hits: Optional[int] = None
    # byte flows for this run (PartitionStore / host tier accounting):
    # bytes_cold moved host->device on the critical path, bytes_prefetched
    # moved off it, bytes_disk came off the disk tier (demand + read-ahead),
    # bytes_host were served out of the host LRU to device staging.  None on
    # hand-built RunStats; engines fill them from the store-stats delta.
    bytes_cold: Optional[int] = None
    bytes_prefetched: Optional[int] = None
    bytes_disk: Optional[int] = None
    bytes_host: Optional[int] = None
    # streaming updates (storage/deltas.py): the graph generation this run
    # was pinned to — every load above resolved against that generation's
    # snapshot, even if a compaction published a newer one mid-run.  None
    # for in-RAM sessions (no generations) and hand-built RunStats.
    generation: Optional[int] = None

    @property
    def n_loads(self) -> int:
        return len(self.loads)

    @property
    def load_ratio(self) -> float:
        if self.n_loads == 0:
            return 1.0
        return min(1.0, self.l_ideal / self.n_loads)


def validate_run_residency(stats: RunStats,
                           per_partition_loads: bool = True
                           ) -> Optional[dict]:
    """Consistency invariant over a run's residency counters: every load
    in ``loads`` was served exactly once by one residency class, so
    ``cold_loads + demand_warm + prefetch_hits == n_loads`` (the store
    counts a prefetch hit as a *kind* of warm load, so ``demand_warm`` is
    ``warm_loads - prefetch_hits``).

    Returns ``None`` when the run carries no residency counters
    (hand-built ``RunStats``); otherwise the disjoint breakdown dict from
    ``obs.metrics.validate_residency``.  Raises ``ValueError`` on
    inconsistent accounting — a store double-count or a load path that
    skipped the counters.

    ``per_partition_loads=False`` skips the ``n_loads`` equality and only
    checks the counters' internal consistency: TraditionalMP's store load
    unit is the stacked top-p bundle (one get per iteration, p entries in
    ``loads``) and MapReduceMP keeps every partition resident
    (``loads == []``), so for those engines the equality doesn't apply.

    When the run also carries byte counters (the memory accounting),
    they are cross-checked against the load counts: a residency class
    with loads must have moved bytes and vice versa (cold_loads > 0 iff
    bytes_cold > 0, disk_reads > 0 iff bytes_disk > 0, ...) — partitions
    are padded arrays, so a zero-byte load means a counter path was
    skipped.  Byte fields left ``None`` are not checked.
    """
    if stats.cold_loads is None or stats.warm_loads is None \
            or stats.prefetch_hits is None:
        return None
    from ..obs.metrics import validate_residency
    if per_partition_loads:
        out = validate_residency(stats.cold_loads, stats.warm_loads,
                                 stats.prefetch_hits, stats.n_loads)
    else:
        out = validate_residency(stats.cold_loads, stats.warm_loads,
                                 stats.prefetch_hits,
                                 stats.cold_loads + stats.warm_loads)
    byte_checks = (
        ("cold_loads", stats.cold_loads, "bytes_cold", stats.bytes_cold),
        ("disk_reads", stats.disk_reads, "bytes_disk", stats.bytes_disk),
    )
    for cname, count, bname, nbytes in byte_checks:
        if count is None or nbytes is None:
            continue
        if int(nbytes) < 0:
            raise ValueError(f"negative byte counter: {bname}={nbytes}")
        if (int(count) > 0) != (int(nbytes) > 0):
            raise ValueError(
                f"{cname}={count} but {bname}={nbytes}: a residency "
                f"class with loads must have moved bytes (and vice "
                f"versa) — a byte-accounting path was skipped")
        out[bname] = int(nbytes)
    for bname, nbytes in (("bytes_prefetched", stats.bytes_prefetched),
                          ("bytes_host", stats.bytes_host)):
        if nbytes is None:
            continue
        if int(nbytes) < 0:
            raise ValueError(f"negative byte counter: {bname}={nbytes}")
        out[bname] = int(nbytes)
    return out


def l_ideal_for_plan(pg: PartitionedGraph, plan: Plan) -> int:
    """#required partitions: any partition holding a node that matches any
    query-node predicate (paper Sec. 1 / 5.3)."""
    from .query import OP_BY_NAME
    from .graph import WILDCARD
    q = plan.query
    g = pg.graph
    required = np.zeros(pg.k, dtype=bool)
    for qn in q.nodes:
        lid = WILDCARD if qn.label == "?" else g.node_vocab.get(qn.label, -3)
        counts = pg.start_label_counts(lid, OP_BY_NAME[qn.value_op],
                                       float(qn.value))
        required |= counts > 0
    return int(required.sum())


def avg_load_ratio_across_schemes(stats: Sequence[RunStats], query: str,
                                  heuristic: str) -> float:
    """h(D)^{query}_{pschemes} (Table 3)."""
    vals = [s.load_ratio for s in stats
            if s.query == query and s.heuristic == heuristic]
    return float(np.mean(vals)) if vals else float("nan")


def avg_load_ratio_for_batch(stats: Sequence[RunStats], scheme: str,
                             heuristic: str) -> float:
    """h(D)^{pscheme}_{qbatch} (Tables 4, 5)."""
    vals = [s.load_ratio for s in stats
            if s.scheme == scheme and s.heuristic == heuristic]
    return float(np.mean(vals)) if vals else float("nan")


def total_connected_components(pg: PartitionedGraph) -> int:
    return int(pg.connected_components_per_partition().sum())
