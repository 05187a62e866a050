"""Workload-aware repartitioning — close the profile -> partitioner loop.

The paper's central claim is that partition characteristics and query
properties must be co-designed: a cut that is optimal for the topology can
still be terrible for the *workload*, because answers that span partitions
force extra loads no heuristic can avoid (Sec. 1, Fig. 4c).  WawPart
(arXiv:2203.14888) closes that gap by repartitioning against observed
traffic; Averbuch & Neumann (arXiv:1301.5121) supply the metric frame —
edge-cut alone vs. query locality — our benchmark table reports.

This module consumes the workload profile a ``GraphSession`` accumulates
(``session.workload_profile()`` / the JSON from ``save_profile()``) and
produces a new vertex assignment by *reweighting* the graph's edges and
re-running the existing multilevel partitioner (``partition_graph``) on
the weighted graph:

  co-traversal pull — the profile's ``answer_spans`` block records how
      often each vertex was bound in a partition-spanning answer
      (``vertex_span_counts``) and, per partition pair, how many answers
      spanned it (``pair_counts``).  A boundary edge whose BOTH endpoints
      were bound in spanning answers gets its weight pulled up
      proportionally, so heavy-edge matching contracts exactly the
      answers' own boundary edges and the new cut routes around them —
      hot spanning structures co-locate while unrelated cut edges stay
      cheap to keep cutting.

  split pressure — partitions with a high share of observed loads and a
      low completion rate (lots of spawning, little finishing) are doing
      spanning work the layout should not preserve.  Their *internal*
      edges keep the minimum weight while calmer partitions' interiors get
      a small cohesion bonus, leaving the partitioner freest to cut
      through exactly the regions the workload says are mis-shaped.

The result is registered under the scheme name ``"waw"`` (knobs below):
``PartitionedGraph.scheme`` / ``RunStats.scheme`` report it, and
``GraphSession.repartition()`` rebuilds a live session against it.

MapReduceMP profiles carry ``partition_counters_observed: false`` (one
compiled program, no host loop): load/completion counters are structurally
zero there, so split pressure is skipped and only the co-traversal term —
which the session observes host-side for every engine — is applied.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Union

import numpy as np

from .graph import Graph, PartitionedGraph, build_partitions
from .partition import PartitionScheme, partition_graph

# The multilevel knobs the reweighted re-run uses (METIS-style kway +
# SHEM, 2 FM rounds — the paper's strongest all-round configuration).
# Deliberately NOT in partition.SCHEMES: "waw" is derived from a profile,
# so sweeping it without weights would just duplicate kway_shem.
WAW_SCHEME = PartitionScheme("waw", "shem", "kway", 2, seed=17)


@dataclasses.dataclass(frozen=True)
class RepartitionConfig:
    """Gains mapping profile observations onto integer edge weights.

    ``boundary_gain`` scales the co-traversal pull: the hottest partition
    pair's boundary edges get weight ``1 + boundary_gain``, colder pairs
    proportionally less.  It must dominate ``cohesion_gain`` (and the unit
    base weight) so heavy-edge matching grabs hot boundary edges first.
    ``cohesion_gain`` scales the stability bonus for interiors of
    partitions the workload is happy with (low split pressure).
    """

    boundary_gain: int = 16
    cohesion_gain: int = 2
    scheme: PartitionScheme = WAW_SCHEME

    def __post_init__(self):
        if self.boundary_gain < 1:
            raise ValueError("boundary_gain must be >= 1")
        if self.cohesion_gain < 0:
            raise ValueError("cohesion_gain must be >= 0")


Profile = Union[str, Dict[str, Any]]


def load_profile(profile: Profile) -> Dict[str, Any]:
    """Accept a ``workload_profile()`` dict or a ``save_profile()`` path."""
    if isinstance(profile, str):
        with open(profile) as f:
            profile = json.load(f)
    if not isinstance(profile, dict) or "partitions" not in profile:
        raise ValueError("not a workload profile (missing 'partitions'); "
                         "expected GraphSession.workload_profile() output")
    return profile


def _profile_assignment(profile: Dict[str, Any], graph: Graph,
                        assignment: Optional[np.ndarray]) -> np.ndarray:
    """The [V] assignment the profile's counters were observed under.

    Saved profiles embed it (``profile["assignment"]``) so a JSON file is
    self-contained; a live caller may pass its own instead.
    """
    if assignment is None:
        emb = profile.get("assignment")
        if emb is None:
            raise ValueError(
                "profile has no embedded 'assignment' and none was passed; "
                "re-save it with GraphSession.save_profile() or supply "
                "assignment= explicitly")
        assignment = np.asarray(emb, dtype=np.int32)
    assignment = np.asarray(assignment, dtype=np.int32)
    if assignment.shape != (graph.n_nodes,):
        raise ValueError(f"assignment shape {assignment.shape} does not "
                         f"match graph ({graph.n_nodes} nodes)")
    return assignment


def reweight_edges(graph: Graph, assignment: np.ndarray,
                   profile: Dict[str, Any],
                   config: RepartitionConfig = RepartitionConfig()
                   ) -> np.ndarray:
    """[E] integer weights encoding the profile's verdict on the layout."""
    k = int(profile["k"])
    if assignment.size and int(assignment.max()) >= k:
        raise ValueError(f"assignment uses partition ids >= profile k={k}")
    E = graph.n_edges
    w = np.ones(E, dtype=np.int64)
    pu = assignment[graph.edge_src]
    pv = assignment[graph.edge_dst]
    cross = pu != pv

    # -- co-traversal pull on boundary edges -------------------------------
    # Primary signal: per-vertex spanning-answer counts.  An edge is pulled
    # up only when BOTH endpoints were bound in partition-spanning answers
    # (min-combine) — that is the answers' own boundary, not every edge
    # that happens to cross a hot partition pair, so unrelated background
    # cut edges keep weight 1 and the new cut is free to go through them.
    spans = profile.get("answer_spans") or {}
    vsc = spans.get("vertex_span_counts")
    if vsc is not None and cross.any():
        vsc = np.asarray(vsc, dtype=np.float64)
        if vsc.shape != (graph.n_nodes,):
            raise ValueError(f"vertex_span_counts length {vsc.shape} != "
                             f"V ({graph.n_nodes})")
        hot = np.minimum(vsc[graph.edge_src], vsc[graph.edge_dst])
        hot[~cross] = 0.0
        peak = hot.max()
        if peak > 0:
            w[cross] += np.round(
                config.boundary_gain * hot[cross] / peak).astype(np.int64)
    else:
        # coarse fallback for pre-vertex-count profiles: pull up every edge
        # crossing a frequently co-spanned partition pair
        pairs = np.asarray(spans.get("pair_counts", np.zeros((k, k))),
                           dtype=np.float64)
        if pairs.shape != (k, k):
            raise ValueError(f"pair_counts shape {pairs.shape} != ({k}, {k})")
        co = pairs.copy()
        np.fill_diagonal(co, 0.0)      # diagonal = within-partition answers
        peak = co.max()
        if peak > 0 and cross.any():
            share = co[pu[cross], pv[cross]] / peak
            w[cross] += np.round(config.boundary_gain * share).astype(np.int64)

    # -- split pressure on partition interiors -----------------------------
    # only meaningful when the engine actually observed per-partition
    # load/yield counters (not MapReduceMP's compiled whole-job run)
    if profile.get("partition_counters_observed", True) and config.cohesion_gain:
        loads = np.zeros(k, dtype=np.float64)
        rates = np.full(k, 0.5, dtype=np.float64)
        for p in profile["partitions"]:
            loads[int(p["pid"])] = float(p.get("loads", 0))
            rates[int(p["pid"])] = float(p.get("completion_rate", 0.5))
        if loads.sum() > 0:
            load_share = loads / loads.sum()
            pressure = load_share * (1.0 - rates)       # in [0, 1]
            top = pressure.max()
            if top > 0:
                calm = 1.0 - pressure / top             # 0 = most pressured
                bonus = np.round(config.cohesion_gain * calm[pu]).astype(np.int64)
                w[~cross] += bonus[~cross]
    return w


def repartition_assignment(graph: Graph, profile: Profile, *,
                           assignment: Optional[np.ndarray] = None,
                           k: Optional[int] = None,
                           seed: Optional[int] = None,
                           config: RepartitionConfig = RepartitionConfig()
                           ) -> np.ndarray:
    """Profile -> reweighted graph -> multilevel re-run -> new [V] assignment.

    Deterministic for a fixed (profile, seed): the reweighting is pure
    arithmetic and ``partition_graph`` seeds its own rng from the scheme.
    """
    prof = load_profile(profile)
    base = _profile_assignment(prof, graph, assignment)
    kk = int(k if k is not None else prof["k"])
    w = reweight_edges(graph, base, prof, config)
    return partition_graph(graph, kk, config.scheme, seed=seed,
                           edge_weights=w)


def repartition(pg: PartitionedGraph, profile: Profile, *,
                seed: Optional[int] = None,
                config: RepartitionConfig = RepartitionConfig()
                ) -> PartitionedGraph:
    """Rebuild a ``PartitionedGraph`` under the workload-aware assignment
    (scheme name ``"waw"``), same k and padding discipline as the input.

    The reweighting runs against the assignment the profile's counters
    were OBSERVED under — the embedded ``profile["assignment"]`` when
    present (its length doubles as the graph-identity check), falling back
    to ``pg.assignment`` only for older profiles without one.  Using the
    current layout for a profile observed under a different one would pull
    up the wrong boundary edges.
    """
    prof = load_profile(profile)
    fallback = None if prof.get("assignment") is not None else pg.assignment
    assign = repartition_assignment(pg.graph, prof,
                                    assignment=fallback, k=pg.k,
                                    seed=seed, config=config)
    return build_partitions(pg.graph, assign, pg.k, scheme=config.scheme.name)


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
