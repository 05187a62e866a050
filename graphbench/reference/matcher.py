"""A plain subgraph matcher in NumPy: the reference that decides
``correct``.

It reads the benchmark's ``GraphArrays`` and a query dict and nothing of
the program.  Semantics (those of ``repro_torch.core.oracle``, which the
port's engines are held to):

  * answers are injective bindings of every query node (slot) to a
    vertex, one row each; automorphic embeddings are distinct rows;
  * a node matches on its label (``?`` matches every vertex, a label the
    graph lacks matches none) and its value predicate (``=``, ``!=``,
    ``<``, ``<=``, ``>``, ``>=``, compared in float32; a vertex without a
    value fails every predicate, ``!=`` too);
  * an edge matches on its label (``?`` any) and direction: an
    undirected graph edge satisfies any direction, a directed one
    ``out`` (1) along and ``in`` (2) against it, as seen from the query
    edge's ``a`` end; ``any`` (0) either;
  * a query is the union of its disjuncts' answers, each row padded with
    -1 to the widest disjunct.

The matcher joins one query node at a time, from the node with the
fewest candidates outwards, over a symmetrized CSR.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

WILDCARD = "?"
QDIR_ANY, QDIR_OUT, QDIR_IN = 0, 1, 2


def _value_ok(values: np.ndarray, op: str, v: float) -> np.ndarray:
    if op == "":
        return np.ones(values.shape, dtype=bool)
    v = np.float32(v)
    finite = ~np.isnan(values)
    with np.errstate(invalid="ignore"):
        cmp = {"=": values == v, "!=": values != v, "<": values < v,
               "<=": values <= v, ">": values > v, ">=": values >= v}
    if op not in cmp:
        raise ValueError(f"bad value op {op!r}")
    return finite & cmp[op]


def _dir_ok(qdir: int, from_a: bool, gdir: np.ndarray) -> np.ndarray:
    """gdir: +1 the graph edge runs along the traversal, -1 against it, 0
    undirected."""
    if not from_a:
        qdir = {QDIR_ANY: QDIR_ANY, QDIR_OUT: QDIR_IN, QDIR_IN: QDIR_OUT}[qdir]
    if qdir == QDIR_ANY:
        return np.ones(gdir.shape, dtype=bool)
    want = 1 if qdir == QDIR_OUT else -1
    return (gdir == 0) | (gdir == want)


class Matcher:
    """All answers of a query on one graph.  ``values`` replaces the
    graph's vertex values; ``keep_edge`` [E] drops the edges it marks
    False (both used by the control, ``graphbench.check``)."""

    def __init__(self, g, values: Optional[np.ndarray] = None,
                 keep_edge: Optional[np.ndarray] = None):
        self.n = g.n_nodes
        self.label = np.asarray(g.node_label, dtype=np.int64)
        self.value = np.asarray(g.node_value if values is None else values,
                                dtype=np.float32)
        self.node_ids: Dict[str, int] = {s: i for i, s in enumerate(g.node_labels)}
        self.edge_ids: Dict[str, int] = {s: i for i, s in enumerate(g.edge_labels)}
        src = np.asarray(g.edge_src, dtype=np.int64)
        dst = np.asarray(g.edge_dst, dtype=np.int64)
        lab = np.asarray(g.edge_label, dtype=np.int64)
        directed = np.asarray(g.edge_directed, dtype=bool)
        if keep_edge is not None:
            src, dst, lab, directed = (x[keep_edge] for x in (src, dst, lab, directed))
        s = np.concatenate([src, dst])
        d = np.concatenate([dst, src])
        gdir = np.concatenate([np.where(directed, 1, 0), np.where(directed, -1, 0)])
        order = np.argsort(s, kind="stable")
        self.nbr = d[order]
        self.elab = np.concatenate([lab, lab])[order]
        self.gdir = gdir[order]
        self.ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(np.bincount(s, minlength=self.n), out=self.ptr[1:])
        # every (from, to) pair, sorted, for the existence checks of
        # query edges that close on an already bound node
        self.pair = s[order] * self.n + self.nbr
        porder = np.argsort(self.pair, kind="stable")
        self.pair_sorted = self.pair[porder]
        self.pair_elab = self.elab[porder]
        self.pair_gdir = self.gdir[porder]

    # -- pieces ---------------------------------------------------------------

    def _node_mask(self, node: dict) -> np.ndarray:
        lab = node.get("label", WILDCARD)
        if lab == WILDCARD:
            ok = np.ones(self.n, dtype=bool)
        elif lab in self.node_ids:
            ok = self.label == self.node_ids[lab]
        else:
            ok = np.zeros(self.n, dtype=bool)
        return ok & _value_ok(self.value, node.get("value_op", ""),
                              float(node.get("value", 0.0)))

    def _edge_label_ok(self, label: str, elab: np.ndarray) -> np.ndarray:
        if label == WILDCARD:
            return np.ones(elab.shape, dtype=bool)
        if label not in self.edge_ids:
            return np.zeros(elab.shape, dtype=bool)
        return elab == self.edge_ids[label]

    def _has_edge(self, a: np.ndarray, b: np.ndarray, edge: dict,
                  from_a: bool) -> np.ndarray:
        """Whether a graph edge from each a[i] to b[i] matches ``edge``."""
        key = a * self.n + b
        lo = np.searchsorted(self.pair_sorted, key, side="left")
        hi = np.searchsorted(self.pair_sorted, key, side="right")
        cnt = hi - lo
        if not cnt.any():
            return np.zeros(a.shape, dtype=bool)
        owner = np.repeat(np.arange(a.shape[0]), cnt)
        pos = np.repeat(lo, cnt) + (np.arange(owner.shape[0])
                                    - np.repeat(np.cumsum(cnt) - cnt, cnt))
        ok = (self._edge_label_ok(edge.get("label", WILDCARD), self.pair_elab[pos])
              & _dir_ok(int(edge.get("direction", 0)), from_a, self.pair_gdir[pos]))
        return np.bincount(owner[ok], minlength=a.shape[0]) > 0

    # -- matching -------------------------------------------------------------

    def match_pattern(self, pat: dict, width: Optional[int] = None) -> np.ndarray:
        """All answers of one conjunctive pattern: sorted unique rows
        [n, width] int32 (-1 past the pattern's nodes)."""
        nodes, edges = pat["nodes"], pat["edges"]
        Q = len(nodes)
        width = Q if width is None else width
        masks = [self._node_mask(nd) for nd in nodes]
        incident: List[List[int]] = [[] for _ in range(Q)]
        for ei, e in enumerate(edges):
            if e["a"] == e["b"]:
                raise ValueError("a query edge needs two distinct nodes")
            incident[e["a"]].append(ei)
            incident[e["b"]].append(ei)
        start = int(np.argmin([m.sum() for m in masks]))
        rows = np.full((int(masks[start].sum()), Q), -1, dtype=np.int64)
        rows[:, start] = np.flatnonzero(masks[start])
        bound = [start]
        while len(bound) < Q and rows.shape[0]:
            # the next node: the first unbound one joined to a bound one
            step = None
            for t in bound:
                for ei in incident[t]:
                    e = edges[ei]
                    other = e["b"] if e["a"] == t else e["a"]
                    if other not in bound:
                        step = (t, other, ei)
                        break
                if step:
                    break
            if step is None:
                raise ValueError("a query pattern must be connected")
            t, s, ei = step
            v = rows[:, t]
            deg = self.ptr[v + 1] - self.ptr[v]
            rep = np.repeat(np.arange(rows.shape[0]), deg)
            pos = np.repeat(self.ptr[v], deg) + (np.arange(rep.shape[0])
                                                 - np.repeat(np.cumsum(deg) - deg, deg))
            nb = self.nbr[pos]
            e = edges[ei]
            ok = (masks[s][nb]
                  & self._edge_label_ok(e.get("label", WILDCARD), self.elab[pos])
                  & _dir_ok(int(e.get("direction", 0)), e["a"] == t, self.gdir[pos]))
            for c in bound:
                ok &= rows[rep, c] != nb
            new = rows[rep[ok]]
            new[:, s] = nb[ok]
            bound.append(s)
            # every other query edge between s and a bound node must exist
            for ej in incident[s]:
                if ej == ei:
                    continue
                f = edges[ej]
                u = f["b"] if f["a"] == s else f["a"]
                if u not in bound or not new.shape[0]:
                    continue
                new = new[self._has_edge(new[:, s], new[:, u], f, f["a"] == s)]
            rows = new
        if len(bound) < Q:
            rows = rows[:0]
        out = np.full((rows.shape[0], width), -1, dtype=np.int32)
        out[:, :Q] = rows
        return np.unique(out, axis=0) if out.shape[0] else out

    def match(self, q: dict) -> List[np.ndarray]:
        """Each disjunct's answers, padded to the widest disjunct."""
        width = max(len(p["nodes"]) for p in q["disjuncts"])
        return [self.match_pattern(p, width) for p in q["disjuncts"]]


def union(parts: List[np.ndarray]) -> np.ndarray:
    """The sorted unique union of disjuncts' answers."""
    got = [p for p in parts if p.shape[0]]
    if not got:
        return parts[0][:0] if parts else np.zeros((0, 0), dtype=np.int32)
    return np.unique(np.concatenate(got), axis=0)
