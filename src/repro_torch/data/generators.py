"""Synthetic dataset generators mirroring the paper's two datasets (Sec. 7).

``imdb_like_graph``  — a typed movie graph: Movie/Person/Genre/Year/Company
entity nodes linked by labeled edges ("acted_in", "genre_is", "in_year",
"produced_by", ...), with *unique* name labels for people/movies (the paper
notes IMDB answers are often unique because vertex labels are unique) and
numeric year values for comparison predicates.

``subgen_like_graph`` — the paper's Subgen-style uniform random graph with a
configurable number of vertex/edge labels and ``n_embed`` planted instances
of a 4-node template substructure, so queries have many answers that span
partitions (the paper embeds 200 instances).

Both scale down to CPU test sizes; the paper-scale configs live in
``benchmarks/`` (IMDB 1750K/5100K, synthetic 400K/1200K).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.graph import Graph, GraphBuilder
from ..core.query import (DisjunctiveQuery, Query, QueryEdge, QueryNode)


# ---------------------------------------------------------------------------
# IMDB-like
# ---------------------------------------------------------------------------

def imdb_like_graph(n_movies: int = 300, n_people: int = 400,
                    n_companies: int = 40, n_genres: int = 12,
                    year_lo: int = 1980, year_hi: int = 2015,
                    n_communities: int = 8, locality: float = 0.9,
                    seed: int = 0) -> Graph:
    """Typed movie graph WITH community structure: actors/companies mostly
    work within a community (era/industry cluster), as in the real IMDB —
    this is what gives METIS-style partitioners a small cut and makes the
    paper's load ratios (answers mostly within one partition) reproducible.
    ``locality`` is the probability a cast/production edge stays inside the
    movie's community."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder()

    genres = [b.add_node(f"genre_{i}") for i in range(n_genres)]
    years: Dict[int, int] = {y: b.add_node("year", value=float(y))
                             for y in range(year_lo, year_hi + 1)}
    companies = [b.add_node(f"company_{i}") for i in range(n_companies)]
    people = [b.add_node(f"person_{i}") for i in range(n_people)]
    C = max(1, n_communities)
    comm_people = [list(range(c, n_people, C)) for c in range(C)]
    comm_companies = [list(range(c, n_companies, C)) for c in range(C)]
    movies = []
    for i in range(n_movies):
        m = b.add_node(f"movie_{i}")
        movies.append(m)
        c = int(rng.integers(0, C))
        b.add_edge(m, years[int(rng.integers(year_lo, year_hi + 1))], "in_year")
        for g in rng.choice(genres, size=int(rng.integers(1, 4)), replace=False):
            b.add_edge(m, int(g), "genre_is")
        comp_pool = comm_companies[c] if (comm_companies[c]
                                          and rng.random() < locality) \
            else range(n_companies)
        b.add_edge(m, companies[int(rng.choice(list(comp_pool)))], "produced_by")
        n_cast = int(rng.integers(1, 6))
        local_pool = comm_people[c]
        for j in range(n_cast):
            if local_pool and rng.random() < locality:
                p = people[int(rng.choice(local_pool))]
            else:
                p = people[int(rng.integers(0, n_people))]
            role = "acted_in" if (j > 0 or rng.random() < 0.8) else "wrote"
            b.add_edge(int(p), m, role)
    # a few writers as well (community-local)
    for _ in range(n_movies // 3):
        c = int(rng.integers(0, C))
        pool = comm_people[c] or list(range(n_people))
        b.add_edge(people[int(rng.choice(pool))],
                   movies[int(rng.integers(0, n_movies))], "wrote")
    return b.build()


def imdb_queries(graph: Graph, seed: int = 0) -> List[DisjunctiveQuery]:
    """Three queries with the paper's Q1/Q2/Q3 *characteristics*:

    Q1 — person + two genres star (answers likely to need a partition twice),
    Q2 — movie/company/genre/year with a != year predicate (spanning answers),
    Q3 — OR of two patterns (answers often inside one partition).
    """
    rng = np.random.default_rng(seed)
    # pick labels that actually occur so answers exist
    def pick(label_prefix: str) -> str:
        ids = [i for i in range(graph.n_nodes)
               if graph.node_vocab.str_of(int(graph.node_label[i])).startswith(label_prefix)]
        return graph.node_vocab.str_of(int(graph.node_label[int(rng.choice(ids))]))

    person = pick("person_")
    genre_a, genre_b = pick("genre_"), pick("genre_")

    q1 = Query(name="Q1", nodes=[
        QueryNode(label=person),      # 0 actor
        QueryNode(label="?"),         # 1 movie (wildcard)
        QueryNode(label=genre_a),     # 2
        QueryNode(label="?"),         # 3 company
    ], edges=[
        QueryEdge(0, 1, "acted_in"),
        QueryEdge(1, 2, "genre_is"),
        QueryEdge(1, 3, "produced_by"),
    ])

    q2 = Query(name="Q2", nodes=[
        QueryNode(label=person),
        QueryNode(label="?"),                       # movie
        QueryNode(label=genre_b),
        QueryNode(label="year", value_op="!=", value=2000.0),
    ], edges=[
        QueryEdge(0, 1, "acted_in"),
        QueryEdge(1, 2, "genre_is"),
        QueryEdge(1, 3, "in_year"),
    ])

    person2 = pick("person_")
    q3a = Query(name="Q3a", nodes=[
        QueryNode(label=person), QueryNode(label="?"), QueryNode(label="?")],
        edges=[QueryEdge(0, 1, "wrote"), QueryEdge(1, 2, "produced_by")])
    q3b = Query(name="Q3b", nodes=[
        QueryNode(label=person2), QueryNode(label="?"), QueryNode(label="?")],
        edges=[QueryEdge(0, 1, "acted_in"), QueryEdge(1, 2, "produced_by")])

    return [DisjunctiveQuery([q1], name="Q1"),
            DisjunctiveQuery([q2], name="Q2"),
            DisjunctiveQuery([q3a, q3b], name="Q3")]


# ---------------------------------------------------------------------------
# Subgen-like
# ---------------------------------------------------------------------------

TEMPLATE_LABELS = ("tmpl_A", "tmpl_B", "tmpl_C", "tmpl_D")
TEMPLATE_EDGES = (("e_ab", 0, 1), ("e_bc", 1, 2), ("e_bd", 1, 3))


def subgen_like_graph(n_nodes: int = 2000, n_edges: int = 6000,
                      n_vlabels: int = 50, n_elabels: int = 100,
                      n_embed: int = 50, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    # background uniform-label nodes
    for i in range(n_nodes):
        b.add_node(f"v{int(rng.integers(0, n_vlabels))}")
    # embedded template instances (paper: 200 instances of Fig. 6)
    inst_nodes = []
    for _ in range(n_embed):
        ids = [b.add_node(l) for l in TEMPLATE_LABELS]
        for el, a, c in TEMPLATE_EDGES:
            b.add_edge(ids[a], ids[c], el)
        inst_nodes.append(ids)
    total = n_nodes + 4 * n_embed
    # background uniform edges
    for _ in range(n_edges):
        s, d = rng.integers(0, total, size=2)
        while s == d:
            s, d = rng.integers(0, total, size=2)
        b.add_edge(int(s), int(d), f"e{int(rng.integers(0, n_elabels))}")
    # tie instances into the background so they cross partitions
    for ids in inst_nodes:
        s = int(rng.integers(0, n_nodes))
        b.add_edge(s, ids[0], f"e{int(rng.integers(0, n_elabels))}")
    return b.build()


def waw_skewed_graph(n_left: int = 400, n_right: int = 440,
                     intra_edges: int = 1500, bridge_edges: int = 8,
                     n_instances: int = 12, n_cold_pairs: int = 8,
                     seed: int = 0) -> Graph:
    """Skewed-workload benchmark graph for workload-aware repartitioning.

    Two dense background communities ("left"/"right") joined by a few
    bridge edges, so every balanced min cut separates the communities.
    ``n_instances`` hot template instances (the Subgen template of
    ``TEMPLATE_LABELS``) deliberately STRADDLE that cut: A, C, D are
    anchored into the left community (one anchor edge each) and B into the
    right (three anchors), so splitting an instance (cutting its three
    template edges) costs exactly as much as co-locating it (cutting three
    anchors) — a topology-only partitioner is indifferent and, with
    anchors inserted first in adjacency order, dissolves each instance
    into its anchor communities, leaving every hot answer spanning two
    partitions.  Only the observed workload can break the tie: a profile
    of template queries pulls the template edges' weights up and the
    repartitioner co-locates each instance without raising the edge cut.

    ``n_cold_pairs`` plants cold 2-node patterns (``cold_A -e_cold->
    cold_B``) wholly inside the left community — the rarely-queried
    control that must not regress — and also balances the communities'
    node counts (left gains 3 nodes per instance + 2 per cold pair, right
    gains 1 + the pre-sized surplus).
    """
    rng = np.random.default_rng(seed)
    b = GraphBuilder()
    left = [b.add_node(f"bgL{int(rng.integers(0, 20))}") for _ in range(n_left)]
    right = [b.add_node(f"bgR{int(rng.integers(0, 20))}") for _ in range(n_right)]
    for side in (left, right):
        for _ in range(intra_edges):
            s, d = rng.choice(len(side), size=2, replace=False)
            b.add_edge(side[int(s)], side[int(d)],
                       f"e{int(rng.integers(0, 30))}")
    for _ in range(bridge_edges):
        b.add_edge(left[int(rng.integers(0, n_left))],
                   right[int(rng.integers(0, n_right))], "e_bridge")
    # hot template instances straddling the communities.  Anchor edges are
    # added BEFORE template edges so they come first in each instance
    # node's adjacency: the partitioner's tie-breaking (sorted heavy-edge
    # matching takes the first heaviest neighbour) then contracts instance
    # nodes into their anchor communities, i.e. the baseline splits them.
    for _ in range(n_instances):
        ids = [b.add_node(l) for l in TEMPLATE_LABELS]
        a, bb, c, d = ids
        b.add_edge(a, left[int(rng.integers(0, n_left))], "anchor")
        b.add_edge(c, left[int(rng.integers(0, n_left))], "anchor")
        b.add_edge(d, left[int(rng.integers(0, n_left))], "anchor")
        for _ in range(3):
            b.add_edge(bb, right[int(rng.integers(0, n_right))], "anchor")
        for el, s, t in TEMPLATE_EDGES:
            b.add_edge(ids[s], ids[t], el)
    # cold pairs wholly inside the left community
    for _ in range(n_cold_pairs):
        ca = b.add_node("cold_A")
        cb = b.add_node("cold_B")
        b.add_edge(ca, left[int(rng.integers(0, n_left))], "anchor")
        b.add_edge(cb, left[int(rng.integers(0, n_left))], "anchor")
        b.add_edge(ca, cb, "e_cold")
    return b.build()


def waw_skewed_queries(hot_repeats: int = 6) -> List[DisjunctiveQuery]:
    """The skewed query mix for ``waw_skewed_graph``: the hot template
    query repeated ``hot_repeats`` times (the traffic the repartitioner
    should optimise for) plus one cold within-community query (the control
    that must stay cheap)."""
    hot = Query(name="HOT", nodes=[
        QueryNode(label=l) for l in TEMPLATE_LABELS],
        edges=[QueryEdge(0, 1, "e_ab"), QueryEdge(1, 2, "e_bc"),
               QueryEdge(1, 3, "e_bd")])
    cold = Query(name="COLD", nodes=[
        QueryNode(label="cold_A"), QueryNode(label="cold_B")],
        edges=[QueryEdge(0, 1, "e_cold")])
    mix = [DisjunctiveQuery([hot], name=f"HOT{i+1}")
           for i in range(hot_repeats)]
    mix.append(DisjunctiveQuery([cold], name="COLD"))
    return mix


def subgen_queries(graph: Graph) -> List[DisjunctiveQuery]:
    """Q4 — subgraph of the embedded template; Q5 — the template itself;
    Q6 — pattern only partially present (2 nodes + 1 edge exist)."""
    q4 = Query(name="Q4", nodes=[
        QueryNode(label="tmpl_A"), QueryNode(label="tmpl_B"),
        QueryNode(label="tmpl_C")],
        edges=[QueryEdge(0, 1, "e_ab"), QueryEdge(1, 2, "e_bc")])
    q5 = Query(name="Q5", nodes=[
        QueryNode(label=l) for l in TEMPLATE_LABELS],
        edges=[QueryEdge(0, 1, "e_ab"), QueryEdge(1, 2, "e_bc"),
               QueryEdge(1, 3, "e_bd")])
    q6 = Query(name="Q6", nodes=[
        QueryNode(label="tmpl_A"), QueryNode(label="tmpl_B"),
        QueryNode(label="tmpl_D")],
        edges=[QueryEdge(0, 1, "e_ab"), QueryEdge(1, 2, "e_cd_missing")])
    return [DisjunctiveQuery([q4], name="Q4"),
            DisjunctiveQuery([q5], name="Q5"),
            DisjunctiveQuery([q6], name="Q6")]
