"""Whole-graph reference matcher — the correctness ground truth.

The paper validates PGQP against QP-Subdue running on the unpartitioned
graph in main memory.  This module plays that role: a deliberately simple,
*independent* backtracking subgraph matcher over the host numpy graph.  It
shares no code with the partitioned engines, so agreement between the two is
meaningful evidence of correctness (used heavily by the hypothesis property
tests).

Semantics (identical to the engines):
  * injective node mapping (subgraph isomorphism, not homomorphism),
  * undirected graph edges satisfy any query direction; directed graph edges
    match QDIR_OUT along, QDIR_IN against, QDIR_ANY either,
  * nodes without numeric values fail every value predicate,
  * answers are binding rows (slot -> global vertex id); pattern-automorphic
    embeddings count as distinct answers, exactly as in the engines.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .graph import Graph, WILDCARD
from .query import (OP_BY_NAME, QDIR_ANY, QDIR_IN, QDIR_OUT, DisjunctiveQuery,
                    Query)
from .state import apply_value_op


def _build_adj(graph: Graph):
    adj: List[List[tuple]] = [[] for _ in range(graph.n_nodes)]
    for i in range(graph.n_edges):
        s, d = int(graph.edge_src[i]), int(graph.edge_dst[i])
        l = int(graph.edge_label[i])
        directed = bool(graph.edge_directed[i])
        adj[s].append((d, l, +1 if directed else 0))
        adj[d].append((s, l, -1 if directed else 0))
    return adj


def _node_ok(graph: Graph, vid: int, label_id: int, op: int, value: float) -> bool:
    if label_id != WILDCARD and int(graph.node_label[vid]) != label_id:
        return False
    return bool(apply_value_op(op, np.float32(graph.node_value[vid]), value))


def match_query(graph: Graph, query: Query, q_pad: Optional[int] = None
                ) -> np.ndarray:
    """All embeddings as sorted unique [n, q_pad] rows (-1 = unused slot)."""
    query.validate()
    nl = query.node_label_ids(graph)
    el = query.edge_label_ids(graph)
    ops = [OP_BY_NAME[qn.value_op] for qn in query.nodes]
    vals = [float(qn.value) for qn in query.nodes]
    Q = query.n_nodes
    pad = q_pad or Q
    adj = _build_adj(graph)

    # adjacency of the query pattern
    qadj: List[List[tuple]] = [[] for _ in range(Q)]
    for ei, e in enumerate(query.edges):
        qadj[e.a].append((e.b, ei, True))
        qadj[e.b].append((e.a, ei, False))

    results: List[tuple] = []
    binding = [-1] * Q

    def edge_dir_ok(qdir: int, from_a: bool, gdir: int) -> bool:
        if not from_a:  # flip the constraint when traversing b -> a
            qdir = {QDIR_ANY: QDIR_ANY, QDIR_OUT: QDIR_IN, QDIR_IN: QDIR_OUT}[qdir]
        if qdir == QDIR_ANY or gdir == 0:
            return True
        return (qdir == QDIR_OUT and gdir == +1) or (qdir == QDIR_IN and gdir == -1)

    def consistent(slot: int, vid: int) -> bool:
        if vid in binding:
            return False  # injectivity
        if not _node_ok(graph, vid, nl[slot], ops[slot], vals[slot]):
            return False
        # all pattern edges to already-bound neighbours must exist
        for other, ei, from_this in qadj[slot]:
            if binding[other] == -1:
                continue
            qe = query.edges[ei]
            found = False
            for (nbr, lab, gdir) in adj[vid]:
                if nbr != binding[other]:
                    continue
                if el[ei] != WILDCARD and lab != el[ei]:
                    continue
                if not edge_dir_ok(qe.direction, from_this, gdir):
                    continue
                found = True
                break
            if not found:
                return False
        return True

    # order slots BFS from slot 0 so each new slot touches a bound one
    order = [0]
    seen = {0}
    qi = 0
    while qi < len(order):
        for other, _, _ in qadj[order[qi]]:
            if other not in seen:
                seen.add(other)
                order.append(other)
        qi += 1

    def backtrack(oi: int) -> None:
        if oi == Q:
            results.append(tuple(binding))
            return
        slot = order[oi]
        if oi == 0:
            candidates = range(graph.n_nodes)
        else:
            # candidates = neighbours of any bound pattern-neighbour
            cand = set()
            for other, _, _ in qadj[slot]:
                if binding[other] != -1:
                    for (nbr, _, _) in adj[binding[other]]:
                        cand.add(nbr)
            candidates = sorted(cand)
        for vid in candidates:
            if consistent(slot, vid):
                binding[slot] = vid
                backtrack(oi + 1)
                binding[slot] = -1

    backtrack(0)
    out = np.full((len(results), pad), -1, dtype=np.int32)
    for i, r in enumerate(sorted(set(results))):
        out[i, :Q] = r
    return np.unique(out, axis=0) if out.shape[0] else out


def match_disjunctive(graph: Graph, dq: DisjunctiveQuery,
                      q_pad: Optional[int] = None) -> np.ndarray:
    pad = q_pad or max(q.n_nodes for q in dq.disjuncts)
    parts = [match_query(graph, q, q_pad=pad) for q in dq.disjuncts]
    parts = [p for p in parts if p.shape[0]]
    if not parts:
        return np.zeros((0, pad), dtype=np.int32)
    return np.unique(np.concatenate(parts, axis=0), axis=0)
