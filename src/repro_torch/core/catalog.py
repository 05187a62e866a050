"""Graph catalog (QP-Subdue style metadata, paper Sec. 3).

Built in a single pass over the graph database; contains the statistics the
cost-based planner consumes:

  * type cardinality            — #nodes per node label
  * average instance cardinality — #nodes / #distinct labels
  * connection cardinality      — #edges per (src_label, edge_label, dst_label)
  * min / max numeric value per node label
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .graph import Graph, WILDCARD


@dataclasses.dataclass
class Catalog:
    n_nodes: int
    n_edges: int
    type_card: np.ndarray                         # [n_node_labels] int64
    avg_instance_card: float
    # connection cardinality keyed by (src_label, edge_label, dst_label);
    # symmetrized (both orientations present).
    conn_card: Dict[Tuple[int, int, int], int]
    # per-(edge_label) totals for wildcard estimates
    edge_label_card: np.ndarray                   # [n_edge_labels] int64
    value_min: np.ndarray                         # [n_node_labels] float32
    value_max: np.ndarray                         # [n_node_labels] float32

    def label_cardinality(self, label_id: int) -> float:
        if label_id == WILDCARD:
            return float(self.n_nodes)
        if label_id < 0 or label_id >= self.type_card.shape[0]:
            return 0.0
        return float(self.type_card[label_id])

    def connection_cardinality(self, src_label: int, edge_label: int,
                               dst_label: int) -> float:
        """Estimated #edges matching (src_label)-[edge_label]-(dst_label),
        falling back to independence assumptions for wildcards."""
        if src_label != WILDCARD and edge_label != WILDCARD and dst_label != WILDCARD:
            return float(self.conn_card.get((src_label, edge_label, dst_label), 0))
        # wildcard fallbacks: scale the closest known aggregate
        if edge_label == WILDCARD:
            total = float(self.n_edges)
        elif 0 <= edge_label < self.edge_label_card.shape[0]:
            total = float(self.edge_label_card[edge_label])
        else:
            total = 0.0   # NO_MATCH edge label
        frac_src = self.label_cardinality(src_label) / max(1.0, self.n_nodes)
        frac_dst = self.label_cardinality(dst_label) / max(1.0, self.n_nodes)
        if src_label != WILDCARD:
            total *= frac_src * self._label_edge_bias(src_label)
        if dst_label != WILDCARD:
            total *= frac_dst * self._label_edge_bias(dst_label)
        return max(total, 0.0)

    def _label_edge_bias(self, label_id: int) -> float:
        # crude degree-bias correction; 1.0 keeps the independence estimate
        return 1.0

    def value_selectivity(self, label_id: int, op: int, value: float) -> float:
        """Fraction of label_id nodes surviving a value predicate (uniformity
        assumption over [min, max], as in relational optimizers)."""
        from .query import OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_NONE
        if op == OP_NONE:
            return 1.0
        if label_id == WILDCARD:
            return 0.5 if op not in (OP_EQ,) else 0.1
        if label_id < 0 or label_id >= self.value_min.shape[0]:
            return 0.0   # NO_MATCH / unknown label: nothing survives
        lo = float(self.value_min[label_id])
        hi = float(self.value_max[label_id])
        if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
            return {OP_EQ: 0.1, OP_NE: 0.9}.get(op, 0.5)
        span = hi - lo
        if op == OP_EQ:
            return max(1.0 / max(2.0, self.label_cardinality(label_id)), 1e-6)
        if op == OP_NE:
            return 1.0 - max(1.0 / max(2.0, self.label_cardinality(label_id)), 1e-6)
        if op in (OP_LT, OP_LE):
            return float(np.clip((value - lo) / span, 0.0, 1.0))
        if op in (OP_GT, OP_GE):
            return float(np.clip((hi - value) / span, 0.0, 1.0))
        return 0.5


def build_catalog(graph: Graph) -> Catalog:
    n_nl = max(1, len(graph.node_vocab))
    n_el = max(1, len(graph.edge_vocab))
    type_card = np.bincount(graph.node_label, minlength=n_nl).astype(np.int64)
    edge_label_card = np.bincount(graph.edge_label, minlength=n_el).astype(np.int64)

    conn: Dict[Tuple[int, int, int], int] = {}
    sl = graph.node_label[graph.edge_src]
    dl = graph.node_label[graph.edge_dst]
    el = graph.edge_label
    # symmetrize: count both orientations (plans may expand either way)
    for a, e, b in zip(np.concatenate([sl, dl]), np.concatenate([el, el]),
                       np.concatenate([dl, sl])):
        key = (int(a), int(e), int(b))
        conn[key] = conn.get(key, 0) + 1

    vmin = np.full(n_nl, np.inf, dtype=np.float64)
    vmax = np.full(n_nl, -np.inf, dtype=np.float64)
    finite = np.isfinite(graph.node_value)
    if finite.any():
        np.minimum.at(vmin, graph.node_label[finite], graph.node_value[finite].astype(np.float64))
        np.maximum.at(vmax, graph.node_label[finite], graph.node_value[finite].astype(np.float64))
    vmin[~np.isfinite(vmin)] = np.nan
    vmax[~np.isfinite(vmax)] = np.nan

    return Catalog(
        n_nodes=graph.n_nodes,
        n_edges=graph.n_edges,
        type_card=type_card,
        avg_instance_card=graph.n_nodes / max(1, len(graph.node_vocab)),
        conn_card=conn,
        edge_label_card=edge_label_card,
        value_min=vmin.astype(np.float32),
        value_max=vmax.astype(np.float32),
    )
