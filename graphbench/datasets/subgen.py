"""The paper's Subgen graph (Das et al. 2019, Sec. 7): a uniform random
graph over ``n_vlabels`` vertex and ``n_elabels`` edge labels with
``n_embed`` planted instances of the Fig. 6 template (A -e_ab- B, B -e_bc-
C, B -e_bd- D), each tied to a random background vertex.

The draws follow ``repro_torch.data.generators.subgen_like_graph``: labels
uniform, background edge ends uniform over all vertices with no
self-loop, one tie from a uniform background vertex to each instance's A.
Vectorised, and split into the fixed shape and the run's draws
(``graphbench.datasets``).  Queries: ``subgen_queries`` (Q4 the A-B-C
path, Q5 the template, Q6 a pattern absent from the graph).
"""
from __future__ import annotations

import numpy as np

from . import GraphArrays, edge_spec, node_spec, pattern, query

TEMPLATE_LABELS = ("tmpl_A", "tmpl_B", "tmpl_C", "tmpl_D")
TEMPLATE_EDGES = (("e_ab", 0, 1), ("e_bc", 1, 2), ("e_bd", 1, 3))
TEMPLATES = ("Q4", "Q5", "Q6")


def make(cfg: dict, seed: int) -> GraphArrays:
    n = int(cfg["n_nodes"])
    m = int(cfg["n_edges"])
    nv = int(cfg["n_vlabels"])
    ne = int(cfg["n_elabels"])
    k = int(cfg["n_embed"])
    total = n + 4 * k
    shape = np.random.default_rng(int(cfg["structure_seed"]))
    src = shape.integers(0, total, m)
    dst = shape.integers(0, total, m)
    loops = np.flatnonzero(src == dst)
    while loops.size:
        src[loops] = shape.integers(0, total, loops.size)
        dst[loops] = shape.integers(0, total, loops.size)
        loops = loops[src[loops] == dst[loops]]
    tie = shape.integers(0, n, k)

    run = np.random.default_rng(seed)
    first = n + 4 * np.arange(k)
    t_src = (first[:, None] + np.array([a for _, a, _ in TEMPLATE_EDGES])).ravel()
    t_dst = (first[:, None] + np.array([b for _, _, b in TEMPLATE_EDGES])).ravel()
    t_lab = np.tile(np.arange(len(TEMPLATE_EDGES)), k)
    n_tl = len(TEMPLATE_EDGES)
    node_label = np.concatenate([run.integers(0, nv, n),
                                 np.tile(nv + np.arange(4), k)])
    g = GraphArrays(
        node_label=node_label.astype(np.int32),
        node_value=np.full(total, np.nan, dtype=np.float32),
        edge_src=np.concatenate([t_src, src, tie]).astype(np.int32),
        edge_dst=np.concatenate([t_dst, dst, first]).astype(np.int32),
        edge_label=np.concatenate([t_lab, n_tl + run.integers(0, ne, m),
                                   n_tl + run.integers(0, ne, k)]).astype(np.int32),
        edge_directed=np.zeros(3 * k + m + k, dtype=bool),
        node_labels=[f"v{i}" for i in range(nv)] + list(TEMPLATE_LABELS),
        edge_labels=[e for e, _, _ in TEMPLATE_EDGES] + [f"e{i}" for i in range(ne)])
    return g.renumbered(run.permutation(total))


def make_query(g: GraphArrays, cfg: dict, template: str,
               rng: np.random.Generator) -> dict:
    """Q4, Q5 or Q6; they take no parameters, so ``rng`` is unused."""
    a, b, c, d = (node_spec(lab) for lab in TEMPLATE_LABELS)
    if template == "Q4":
        return query("Q4", pattern("Q4", [a, b, c], [
            edge_spec(0, 1, "e_ab"), edge_spec(1, 2, "e_bc")]))
    if template == "Q5":
        return query("Q5", pattern("Q5", [a, b, c, d], [
            edge_spec(0, 1, "e_ab"), edge_spec(1, 2, "e_bc"),
            edge_spec(1, 3, "e_bd")]))
    if template == "Q6":
        return query("Q6", pattern("Q6", [a, b, d], [
            edge_spec(0, 1, "e_ab"), edge_spec(1, 2, "e_cd_missing")]))
    raise ValueError(f"subgen has no template {template!r}")
