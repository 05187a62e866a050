"""Cost-based query plan generation (QP-Subdue style, paper Sec. 3).

A plan linearizes the query pattern into a sequence of one-edge expansion
steps starting from a chosen *start node*.  Candidate plans are generated
for every query node as a potential start, costed with catalog statistics
(estimated intermediate-result cardinality after each step, summed), and the
minimum-cost plan is executed — the same strategy QP-Subdue uses.

The emitted ``PlanArrays`` is the fixed-shape array form every engine (OPAT,
TraditionalMP, MapReduceMP) and the Pallas kernel consume.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .catalog import Catalog
from .graph import Graph
from .query import OP_BY_NAME, QDIR_ANY, QDIR_IN, QDIR_OUT, Query


@dataclasses.dataclass
class PlanStep:
    src_slot: int          # already-bound query-node slot we expand from
    dst_slot: int          # slot being bound (or checked, if closes_cycle)
    edge_label: int        # interned id or WILDCARD
    direction: int         # QDIR_* seen from src_slot
    dst_label: int         # interned id or WILDCARD
    dst_value_op: int      # OP_*
    dst_value: float
    closes_cycle: bool     # dst_slot already bound -> edge-existence check


@dataclasses.dataclass
class Plan:
    query: Query
    start_slot: int        # query-node index bound first
    start_label: int
    start_value_op: int
    start_value: float
    steps: List[PlanStep]
    est_cost: float

    @property
    def n_slots(self) -> int:
        return self.query.n_nodes

    @property
    def n_steps(self) -> int:
        return len(self.steps)

    def max_path_len(self) -> int:
        """Longest root-to-leaf path (in steps) of the plan tree — the paper's
        upper bound on TraditionalMP / MapReduceMP iterations (Sec. 8.2, 9)."""
        depth = {self.start_slot: 0}
        best = 0
        for s in self.steps:
            d = depth.get(s.src_slot, 0) + 1
            if not s.closes_cycle:
                depth[s.dst_slot] = d
            best = max(best, d)
        return best


@dataclasses.dataclass
class PlanArrays:
    """jnp-friendly plan encoding (all int32/float32, fixed length S)."""

    n_slots: int
    n_steps: int
    start_slot: np.ndarray      # [] int32
    start_label: np.ndarray     # [] int32
    start_value_op: np.ndarray  # [] int32
    start_value: np.ndarray     # [] float32
    src_slot: np.ndarray        # [S] int32
    dst_slot: np.ndarray        # [S] int32
    edge_label: np.ndarray      # [S] int32
    direction: np.ndarray       # [S] int32
    dst_label: np.ndarray       # [S] int32
    dst_value_op: np.ndarray    # [S] int32
    dst_value: np.ndarray       # [S] float32
    closes_cycle: np.ndarray    # [S] int32 (0/1)

    @staticmethod
    def from_plan(plan: Plan, pad_steps: Optional[int] = None) -> "PlanArrays":
        S = plan.n_steps if pad_steps is None else pad_steps
        assert S >= plan.n_steps
        def arr(fn, dtype):
            a = np.zeros(S, dtype=dtype)
            for i, s in enumerate(plan.steps):
                a[i] = fn(s)
            return a
        return PlanArrays(
            n_slots=plan.n_slots,
            n_steps=plan.n_steps,
            start_slot=np.int32(plan.start_slot),
            start_label=np.int32(plan.start_label),
            start_value_op=np.int32(plan.start_value_op),
            start_value=np.float32(plan.start_value),
            src_slot=arr(lambda s: s.src_slot, np.int32),
            dst_slot=arr(lambda s: s.dst_slot, np.int32),
            edge_label=arr(lambda s: s.edge_label, np.int32),
            direction=arr(lambda s: s.direction, np.int32),
            dst_label=arr(lambda s: s.dst_label, np.int32),
            dst_value_op=arr(lambda s: s.dst_value_op, np.int32),
            dst_value=arr(lambda s: s.dst_value, np.float32),
            closes_cycle=arr(lambda s: int(s.closes_cycle), np.int32),
        )

    @staticmethod
    def stack(plans: Sequence["PlanArrays"]) -> "PlanArrays":
        """Stack B same-padding plans into one [B, ...] ``PlanArrays`` — the
        unit the scheduler's batched partition evaluator consumes (each
        leaf gains a leading batch axis; ``jax.vmap`` maps over it while
        the partition inputs broadcast).  The scalar ``n_slots`` /
        ``n_steps`` metadata is not meaningful for a stacked bundle (each
        plan keeps its own runtime ``n_steps`` argument), so it is pinned
        to (0, S): a *constant* aux for the jit cache, ensuring one trace
        per batch-size bucket regardless of which plans are stacked."""
        assert plans, "need at least one plan to stack"
        S = plans[0].src_slot.shape[0]
        assert all(p.src_slot.shape[0] == S for p in plans), \
            "stacked plans must share one padded step count"
        fields = ("start_slot", "start_label", "start_value_op", "start_value",
                  "src_slot", "dst_slot", "edge_label", "direction",
                  "dst_label", "dst_value_op", "dst_value", "closes_cycle")
        stacked = {f: np.stack([np.asarray(getattr(p, f)) for p in plans])
                   for f in fields}
        return PlanArrays(n_slots=0, n_steps=S, **stacked)


def _enumerate_orders(query: Query, start: int) -> List[List[Tuple[int, bool]]]:
    """All BFS-ish edge orders are exponential; we use the greedy order only
    (chosen per-step by estimated fanout) — matching QP-Subdue's practical
    planner.  Returns a single greedy order as [(edge_idx, forward_from_a)]."""
    return []  # greedy order is computed inline in generate_plan


def _greedy_plan(query: Query, graph: Graph, catalog: Catalog,
                 start: int) -> Optional[Plan]:
    nl = query.node_label_ids(graph)
    el = query.edge_label_ids(graph)
    bound = {start}
    remaining = set(range(len(query.edges)))
    steps: List[PlanStep] = []
    start_op = OP_BY_NAME[query.nodes[start].value_op]
    start_sel = catalog.value_selectivity(nl[start], start_op, query.nodes[start].value)
    card = catalog.label_cardinality(nl[start]) * start_sel
    if card == 0.0:
        card = 1e-3  # unknown label: still a valid (cheap) plan
    cost = card

    while remaining:
        best = None  # (est_new_card, edge_idx, src_slot, dst_slot, closes)
        for ei in list(remaining):
            e = query.edges[ei]
            a_in, b_in = e.a in bound, e.b in bound
            if not (a_in or b_in):
                continue
            closes = a_in and b_in
            src, dst = (e.a, e.b) if a_in else (e.b, e.a)
            conn = catalog.connection_cardinality(nl[src], el[ei], nl[dst])
            src_card = max(1.0, catalog.label_cardinality(nl[src]))
            fanout = conn / src_card
            dst_op = OP_BY_NAME[query.nodes[dst].value_op]
            sel = catalog.value_selectivity(nl[dst], dst_op, query.nodes[dst].value)
            if closes:
                # cycle closure filters; estimate survival prob ~ fanout / |dst label|
                est = card * min(1.0, fanout / max(1.0, catalog.label_cardinality(nl[dst])))
            else:
                est = card * fanout * sel
            key = (est, ei, src, dst, closes)
            if best is None or est < best[0]:
                best = key
        if best is None:
            return None  # disconnected pattern (validate() prevents this)
        est, ei, src, dst, closes = best
        e = query.edges[ei]
        # direction seen from src
        if e.direction == QDIR_ANY:
            direction = QDIR_ANY
        elif src == e.a:
            direction = e.direction
        else:
            direction = QDIR_IN if e.direction == QDIR_OUT else QDIR_OUT
        dst_op = OP_BY_NAME[query.nodes[dst].value_op]
        steps.append(PlanStep(
            src_slot=src, dst_slot=dst, edge_label=el[ei], direction=direction,
            dst_label=nl[dst], dst_value_op=dst_op,
            dst_value=float(query.nodes[dst].value), closes_cycle=closes))
        remaining.discard(ei)
        bound.add(dst)
        card = max(est, 1e-6)
        cost += card

    return Plan(query=query, start_slot=start, start_label=nl[start],
                start_value_op=start_op,
                start_value=float(query.nodes[start].value),
                steps=steps, est_cost=cost)


def generate_plan(query: Query, graph: Graph, catalog: Catalog,
                  start_slot: Optional[int] = None) -> Plan:
    """Generate the minimum-estimated-cost plan over all start-node choices
    (or for a forced ``start_slot``)."""
    query.validate()
    candidates = range(query.n_nodes) if start_slot is None else [start_slot]
    best: Optional[Plan] = None
    for s in candidates:
        # prefer concrete-label starts: wildcard starts scan every node
        p = _greedy_plan(query, graph, catalog, s)
        if p is None:
            continue
        if best is None or p.est_cost < best.est_cost:
            best = p
    assert best is not None, "no valid plan (pattern disconnected?)"
    return best
