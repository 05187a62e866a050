"""Query representation for PGQP-JAX.

The paper's queries (QP-Subdue style) are subgraph patterns whose nodes and
edges carry label predicates, comparison operators over numeric values
(<, <=, >, >=, !=, =), wildcards ('?'), and Boolean combinations (AND / OR).

A ``Query`` here is a single conjunctive pattern (AND of all node/edge
predicates).  OR queries are normalized to a *disjunction of conjunctive
patterns* (DNF) — the paper's Q3 ("Fred Wolf writer OR Salma Hayek actress")
becomes two patterns whose answer sets are unioned; this is exactly how
QP-Subdue handles top-level ORs (one plan per disjunct).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


from .graph import Graph, WILDCARD

NO_MATCH = -3  # label absent from the graph vocabulary; matches nothing

# value comparison ops
OP_NONE, OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE = 0, 1, 2, 3, 4, 5, 6
OP_BY_NAME = {"": OP_NONE, "=": OP_EQ, "!=": OP_NE, "<": OP_LT, "<=": OP_LE,
              ">": OP_GT, ">=": OP_GE}

# edge direction constraint in a query
QDIR_ANY, QDIR_OUT, QDIR_IN = 0, 1, 2


@dataclasses.dataclass
class QueryNode:
    label: str = "?"                 # "?" is a wildcard
    value_op: str = ""               # one of OP_BY_NAME keys
    value: float = 0.0


@dataclasses.dataclass
class QueryEdge:
    a: int                           # query-node index
    b: int
    label: str = "?"
    direction: int = QDIR_ANY        # constraint from a's point of view


@dataclasses.dataclass
class Query:
    """One conjunctive subgraph pattern."""

    nodes: List[QueryNode]
    edges: List[QueryEdge]
    name: str = "q"

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def to_json_dict(self) -> dict:
        """Plain-JSON form — one line of a ``serve.py --workload`` file."""
        return {
            "name": self.name,
            "nodes": [dataclasses.asdict(n) for n in self.nodes],
            "edges": [dataclasses.asdict(e) for e in self.edges],
        }

    @staticmethod
    def from_json_dict(d: dict) -> "Query":
        q = Query(
            nodes=[QueryNode(**n) for n in d["nodes"]],
            edges=[QueryEdge(**e) for e in d["edges"]],
            name=d.get("name", "q"))
        q.validate()
        return q

    def validate(self) -> None:
        n = self.n_nodes
        assert n >= 1
        for e in self.edges:
            assert 0 <= e.a < n and 0 <= e.b < n and e.a != e.b
        # the pattern must be connected for plan generation
        if n > 1:
            seen = {0}
            frontier = [0]
            adj = {i: [] for i in range(n)}
            for e in self.edges:
                adj[e.a].append(e.b)
                adj[e.b].append(e.a)
            while frontier:
                v = frontier.pop()
                for u in adj[v]:
                    if u not in seen:
                        seen.add(u)
                        frontier.append(u)
            assert len(seen) == n, "query pattern must be connected"

    def node_label_ids(self, graph: Graph) -> List[int]:
        # labels absent from the graph vocabulary map to NO_MATCH (-3), a
        # sentinel that matches nothing (NOT to the wildcard!)
        return [WILDCARD if qn.label == "?" else graph.node_vocab.get(qn.label, NO_MATCH)
                for qn in self.nodes]

    def edge_label_ids(self, graph: Graph) -> List[int]:
        return [WILDCARD if qe.label == "?" else graph.edge_vocab.get(qe.label, NO_MATCH)
                for qe in self.edges]


@dataclasses.dataclass
class DisjunctiveQuery:
    """Top-level OR of conjunctive patterns (paper's Boolean operators)."""

    disjuncts: List[Query]
    name: str = "q_or"

    def to_json_dict(self) -> dict:
        return {"name": self.name,
                "disjuncts": [q.to_json_dict() for q in self.disjuncts]}

    @staticmethod
    def from_json_dict(d: dict) -> "DisjunctiveQuery":
        """Accepts the full ``{"disjuncts": [...]}`` form or a bare
        conjunctive pattern (treated as a single disjunct) — so a
        workload file can mix both."""
        if "disjuncts" in d:
            if not d["disjuncts"]:
                raise ValueError(
                    f"query {d.get('name', '?')!r} has no disjuncts")
            return DisjunctiveQuery(
                disjuncts=[Query.from_json_dict(q) for q in d["disjuncts"]],
                name=d.get("name", "q_or"))
        q = Query.from_json_dict(d)
        return DisjunctiveQuery([q], name=q.name)


def make_path_query(labels: Sequence[str], edge_labels: Sequence[str],
                    name: str = "path") -> Query:
    """Convenience: a simple path pattern L0 -e0- L1 -e1- L2 ..."""
    assert len(edge_labels) == len(labels) - 1
    nodes = [QueryNode(label=l) for l in labels]
    edges = [QueryEdge(a=i, b=i + 1, label=el) for i, el in enumerate(edge_labels)]
    q = Query(nodes=nodes, edges=edges, name=name)
    q.validate()
    return q


def make_star_query(center: str, leaves: Sequence[Tuple[str, str]],
                    name: str = "star") -> Query:
    """Star pattern: center node connected to each (edge_label, leaf_label)."""
    nodes = [QueryNode(label=center)] + [QueryNode(label=l) for _, l in leaves]
    edges = [QueryEdge(a=0, b=i + 1, label=el) for i, (el, _) in enumerate(leaves)]
    q = Query(nodes=nodes, edges=edges, name=name)
    q.validate()
    return q
