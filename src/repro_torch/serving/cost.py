"""Admission-time cost prediction from catalog/manifest statistics.

A copy of the JAX package's ``serving/cost.py``, logic unchanged.

The paper's thesis is that query properties and partition characteristics
can be *correlated in advance* to bound processing time "in terms of the
resources available" (Sec. 1): the number of start-node instances (SNI)
says how much frontier a partition seeds, the connected-component count
(CC) says how fragmented the partition's intra-edges are (Sec. 5.2), and
the set of *required* partitions bounds the load sequence (L_ideal).  All
three are answerable without touching a partition: the in-RAM path reads
whole-graph arrays + the assignment, and the out-of-core path reads the
manifest's per-partition label histograms and ``components`` field
(storage/format.py) — so a ``CostModel`` can price a query *before
admission* even when every shard is still on disk.

``predict`` maps those statistics to abstract *work units*
(``work_units`` below: required partitions weighted by their CC, plus the
SNI mass they seed, scaled by plan length and the answer budget K), then
to seconds through a per-bucket rate table calibrated online: every
observed ``QueryResult`` latency updates an EWMA of seconds-per-unit in
the bucket ``log2(units)`` (near-constant per-query overheads make small
queries pay a different rate than big ones — bucketing keeps both
honest).  An uncalibrated model prices with ``default_rate_s``; the
serving front end (serving/frontend.py) feeds observations back after
every completion, so the estimate converges while traffic flows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.plan import Plan, generate_plan
from ..core.query import DisjunctiveQuery, Query


def required_partition_mask(pg, plan: Plan) -> np.ndarray:
    """[k] bool: partitions holding at least one node matching ANY query
    node predicate — the same "required partition" set ``l_ideal_for_plan``
    counts (core/metrics.py), kept as a mask so the per-partition CC
    weights can be applied.  Catalog/manifest-only; never reads a shard."""
    from ..core.graph import WILDCARD
    from ..core.query import OP_BY_NAME
    g = pg.graph
    required = np.zeros(pg.k, dtype=bool)
    for qn in plan.query.nodes:
        lid = WILDCARD if qn.label == "?" else g.node_vocab.get(qn.label, -3)
        counts = pg.start_label_counts(lid, OP_BY_NAME[qn.value_op],
                                       float(qn.value))
        required |= counts > 0
    return required


def work_units(sni_counts: np.ndarray, components: np.ndarray,
               required: np.ndarray, n_steps: int = 1, *,
               cc_gain: float = 0.5, sni_gain: float = 0.05,
               step_gain: float = 0.25) -> float:
    """Abstract work for one plan: each required partition costs one load
    plus ``cc_gain`` per extra connected component (fragmented partitions
    re-enter the load sequence, paper Fig. 4c / Sec. 5.2), the seeded SNI
    mass costs ``sni_gain`` per row, and every extra plan step multiplies
    the whole thing (longer plans expand more frontiers per load).

    Monotone by construction: non-decreasing in every SNI count, every
    required partition's CC, the size of the required set, and the plan
    length.
    """
    req = np.asarray(required, dtype=bool)
    cc = np.maximum(np.asarray(components, dtype=np.float64), 1.0)
    base = float(np.sum(1.0 + cc_gain * (cc[req] - 1.0)))
    seeded = float(np.sum(np.asarray(sni_counts, dtype=np.float64)[req]))
    return (base + sni_gain * seeded) * (1.0 + step_gain * max(0, n_steps - 1))


@dataclasses.dataclass
class CostEstimate:
    """One query's admission-time price: predicted loads and latency plus
    the calibration bucket the prediction was read from."""

    work_units: float
    loads: int                     # predicted partition loads (Σ_d |required_d|)
    latency_s: float
    bucket: int                    # log2 work-unit bucket of the rate used
    rate_s: float                  # seconds-per-unit applied
    calibrated: bool               # False: default_rate_s (no observations yet)
    max_answers: Optional[int]     # budget K the estimate was priced under


class CostModel:
    """Predict-then-calibrate latency model over one partitioned graph.

    ``pg`` needs only the catalog surface (``k``, ``start_label_counts``,
    ``connected_components_per_partition``) — an
    ``OutOfCorePartitionedGraph`` answers all three from its manifest.
    ``alpha`` is the EWMA weight of each new observation; ``default_rate_s``
    prices queries before any observation lands.  ``observe`` is cheap and
    thread-free; the serving front end calls it once per completion.
    """

    def __init__(self, pg, *, alpha: float = 0.3,
                 default_rate_s: float = 2e-4,
                 cc_gain: float = 0.5, sni_gain: float = 0.05,
                 step_gain: float = 0.25,
                 min_budget_frac: float = 0.05):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.pg = pg
        self.alpha = float(alpha)
        self.default_rate_s = float(default_rate_s)
        self.cc_gain = float(cc_gain)
        self.sni_gain = float(sni_gain)
        self.step_gain = float(step_gain)
        self.min_budget_frac = float(min_budget_frac)
        # per-partition CC is layout-static: one catalog/manifest read
        self._cc = np.asarray(pg.connected_components_per_partition(),
                              dtype=np.int64)
        self._rates: Dict[int, float] = {}     # bucket -> EWMA seconds/unit
        self._observations = 0

    # -- prediction ---------------------------------------------------------

    @property
    def calibrated(self) -> bool:
        return bool(self._rates)

    @property
    def observations(self) -> int:
        return self._observations

    def _budget_factor(self, plan: Plan,
                       max_answers: Optional[int]) -> float:
        """K answers out of an estimated ``plan.est_cost`` total shrink the
        expected work proportionally (the paper's budgeted runs stop after
        K uniques), floored so a tiny K never predicts free."""
        if max_answers is None:
            return 1.0
        if max_answers <= 0:
            return 0.0
        frac = max_answers / max(1.0, float(plan.est_cost))
        return max(self.min_budget_frac, min(1.0, frac))

    def plan_units(self, plan: Plan,
                   max_answers: Optional[int] = None) -> float:
        """Work units for one disjunct's plan (catalog statistics only)."""
        sni = self.pg.start_label_counts(plan.start_label,
                                         plan.start_value_op,
                                         plan.start_value)
        required = required_partition_mask(self.pg, plan)
        units = work_units(sni, self._cc, required, plan.n_steps,
                           cc_gain=self.cc_gain, sni_gain=self.sni_gain,
                           step_gain=self.step_gain)
        return units * self._budget_factor(plan, max_answers)

    def predict_plans(self, plans: Sequence[Plan],
                      max_answers: Optional[int] = None) -> CostEstimate:
        """Price a query given its per-disjunct plans (the budget K applies
        per disjunct, matching ``submit`` semantics)."""
        units = sum(self.plan_units(p, max_answers) for p in plans)
        loads = sum(int(required_partition_mask(self.pg, p).sum())
                    for p in plans)
        bucket = self._bucket(units)
        rate, calibrated = self._rate_for(bucket)
        return CostEstimate(work_units=units, loads=loads,
                            latency_s=units * rate, bucket=bucket,
                            rate_s=rate, calibrated=calibrated,
                            max_answers=max_answers)

    def predict(self, query: Union[Query, DisjunctiveQuery], graph, catalog,
                max_answers: Optional[int] = None) -> CostEstimate:
        """Convenience: plan the query's disjuncts and price them."""
        disjuncts = (query.disjuncts if isinstance(query, DisjunctiveQuery)
                     else [query])
        plans = [generate_plan(q, graph, catalog) for q in disjuncts]
        return self.predict_plans(plans, max_answers)

    # -- online calibration -------------------------------------------------

    @staticmethod
    def _bucket(units: float) -> int:
        return int(math.log2(max(units, 0.0) + 1.0))

    def _rate_for(self, bucket: int) -> Tuple[float, bool]:
        """(seconds-per-unit, calibrated?) for a bucket: the bucket's own
        EWMA, else the nearest observed bucket's (small-to-large latency
        structure is smooth enough that a neighbour beats the static
        default), else ``default_rate_s``."""
        if bucket in self._rates:
            return self._rates[bucket], True
        if self._rates:
            nearest = min(self._rates, key=lambda b: (abs(b - bucket), b))
            return self._rates[nearest], True
        return self.default_rate_s, False

    def observe(self, estimate: CostEstimate, latency_s: float) -> float:
        """Fold one observed (estimate, latency) pair into the bucket's
        EWMA rate; returns the updated seconds-per-unit."""
        if latency_s < 0:
            raise ValueError(f"latency_s must be >= 0, got {latency_s}")
        units = max(estimate.work_units, 1e-9)
        rate_obs = latency_s / units
        bucket = estimate.bucket
        old = self._rates.get(bucket)
        new = rate_obs if old is None else \
            (1.0 - self.alpha) * old + self.alpha * rate_obs
        self._rates[bucket] = new
        self._observations += 1
        return new

    def snapshot(self) -> Dict[str, object]:
        """Observability: the rate table and counters (serve --json)."""
        return {"observations": self._observations,
                "default_rate_s": self.default_rate_s,
                "rates_s_per_unit": {str(b): self._rates[b]
                                     for b in sorted(self._rates)}}
