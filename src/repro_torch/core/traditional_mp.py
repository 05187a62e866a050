"""TraditionalMP — parallel partition processing with p processors
(paper Sec. 8, Algorithm 1).

Identical bookkeeping to OPAT; the difference is the *set* of partitions
chosen per iteration (top-p under the heuristic) and their parallel
execution.  The chosen partitions ship as one stacked store bundle and
evaluate as lanes of the lane evaluator (``make_batched_evaluator``): one
lane per chosen partition, all sharing the query's plan — the semantics
of p identical processors executing PGQP independently (Algorithm 1
lines 6-8), with one fused-kernel launch per loop iteration for all of
them.  IMA merging order does not matter (line 9), so the host merge loop
is order-insensitive.

The host logic is the JAX package's: top-p by ``choose_top_p``, the set
processed in sorted order and padded to exactly p with its first pid (so
the stacked store key is permutation-invariant and its load counters
equal the reference's), IMA tails beyond ``cap`` kept for a later
iteration.  A padding lane has no input and seeds nothing, so it is left
out of the device call; its results would be empty.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ..obs.profile import NULL_PROFILER
from ..obs.trace import NULL_TRACER
from .engine import (EngineConfig, EvalResult, make_batched_evaluator, plan_to_device,
                     ranked_slots, step_shape)
from .graph import PartitionedGraph
from .heuristics import MAX_YIELD, choose_top_p
from .metrics import RunStats, l_ideal_for_plan
from .opat import absorb_eval_outputs, lane_outputs
from .plan import Plan, PlanArrays
from .runner import RunReport, RunRequest, truncate_answers
from .state import BindingBatch, QueryState
from .store import PartitionStore, StoreEntry


@dataclasses.dataclass
class TraditionalMPResult:
    answers: np.ndarray
    stats: RunStats
    state: QueryState
    partitions_per_iteration: List[List[int]]


def lane_inputs(batches: List[BindingBatch], cap: int, q_pad: int, device):
    """Stack per-lane binding batches (each at most ``cap`` rows) into the
    lane evaluator's [L, cap, ...] input tensors on ``device``."""
    n = len(batches)
    in_rows = np.full((n, cap, q_pad), -1, dtype=np.int32)
    in_step = np.zeros((n, cap), dtype=np.int32)
    in_valid = np.zeros((n, cap), dtype=bool)
    for i, b in enumerate(batches):
        if b.n:
            in_rows[i, : b.n] = b.rows
            in_step[i, : b.n] = b.step
            in_valid[i, : b.n] = True
    return tuple(torch.from_numpy(a).to(device) for a in (in_rows, in_step, in_valid))


class TraditionalMPEngine:
    """``store`` defaults to a private unbounded ``PartitionStore`` on
    ``device`` (None means ``"cuda"``); its load unit is the *stacked*
    top-p bundle one iteration ships to the p processors, so a recurring
    top-p set is a warm load.  ``batched_iters`` sums the loop counts of
    every lane-evaluator call: one fused-kernel launch each."""

    def __init__(self, pg: PartitionedGraph, n_processors: int,
                 cfg: Optional[EngineConfig] = None,
                 store: Optional[PartitionStore] = None,
                 tracer: Optional[Any] = None,
                 device: Union[None, str, torch.device] = None,
                 profiler: Optional[Any] = None):
        assert n_processors >= 1
        self.pg = pg
        self.p = n_processors
        self.cfg = cfg or EngineConfig()
        self._lanes = make_batched_evaluator(self.cfg)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.profiler = profiler if profiler is not None else NULL_PROFILER
        self.store = (store if store is not None
                      else PartitionStore(pg, tracer=self.tracer, device=device,
                                          profiler=self.profiler))
        self.device = self.store.device
        self.batched_iters = 0
        self._eval_called = False

    def shared_evaluator(self):
        """The stacked top-p, multi-query evaluator: the lane evaluator
        bound to this engine.  ``seval(entry, plans, n_steps, lane_part,
        lane_plan, in_rows, in_step, in_valid, seed_fresh)`` evaluates
        each lane's plan (index into the stacked ``plans``) against its
        partition (index into the stacked ``entry``) — the JAX package's
        queries x partitions double ``vmap``, with only the lanes that
        carry work.  This is how the ``QueryScheduler`` shares one top-p
        load across every waiting query (core/scheduler.py)."""
        return self._evaluate

    def _evaluate(self, entry: StoreEntry, plans: PlanArrays, n_steps,
                  lane_part, lane_plan, in_rows, in_step, in_valid,
                  seed_fresh) -> EvalResult:
        res, loops = self._lanes(entry.part, entry.g2l, self.store.owner,
                                 plans, n_steps, lane_part, lane_plan,
                                 in_rows, in_step, in_valid, seed_fresh)
        self.batched_iters += loops
        return res

    def run(self, plan: Plan, heuristic: str, seed: int = 0,
            max_iterations: Optional[int] = None,
            max_answers: Optional[int] = None) -> TraditionalMPResult:
        cfg = self.cfg
        assert plan.n_slots <= cfg.q_pad and plan.n_steps <= cfg.s_pad
        rng = np.random.default_rng(seed)
        plans = plan_to_device(PlanArrays.stack(
            [PlanArrays.from_plan(plan, pad_steps=cfg.s_pad)]), self.device)
        counts = self.pg.start_label_counts(plan.start_label,
                                            plan.start_value_op,
                                            plan.start_value)
        st = QueryState.initial(self.pg.k, cfg.q_pad, counts,
                                track_answer_keys=max_answers is not None)
        limit = max_iterations if max_iterations is not None else 64 * self.pg.k
        per_iter: List[List[int]] = []
        load0 = self.store.stats.copy()

        # budget check after each top-p merge (and before the first load:
        # a K=0 request does no work)
        while not st.budget_met(max_answers):
            eligible = st.eligible()
            if not eligible:
                break
            if st.iterations >= limit:
                raise RuntimeError("TraditionalMP exceeded max iterations")
            sni = {p: st.sni_count(p) for p in eligible}
            rates = (st.completion_rates() if heuristic == MAX_YIELD
                     else None)
            chosen = choose_top_p(heuristic, eligible, sni, self.p, rng,
                                  rates, tracer=self.tracer)
            per_iter.append(list(chosen))
            st.iterations += 1
            # which processor runs which partition is arbitrary (Algorithm
            # 1 lines 6-8): the sorted set, padded to p with its first pid,
            # is the canonical stacked store key, so a permutation of the
            # same top-p set is a warm load
            chosen = sorted(chosen)
            exec_set = list(chosen) + [chosen[0]] * (self.p - len(chosen))
            batches: List[BindingBatch] = []
            seeds: List[bool] = []
            for pid in chosen:
                st.loads.append(pid)
                b = st.ima[pid]
                st.ima[pid] = BindingBatch.empty(cfg.q_pad)
                if b.n > cfg.cap:
                    # keep the tail for a later iteration of the same partition
                    st.ima[pid] = BindingBatch(rows=b.rows[cfg.cap:],
                                               step=b.step[cfg.cap:])
                    b = BindingBatch(rows=b.rows[: cfg.cap],
                                     step=b.step[: cfg.cap])
                batches.append(b)
                seeds.append(bool(st.fresh_pending[pid]))
                st.fresh_pending[pid] = False
            # the real lanes sort to the front of each pid's run in the
            # stacked key (a stable sort on pid); padding lanes carry no
            # work and stay out of the device call
            order = sorted(range(self.p), key=lambda i: exec_set[i])
            exec_set = [exec_set[i] for i in order]
            real = [(pos, i) for pos, i in enumerate(order) if i < len(chosen)]

            with self.tracer.span("engine.iteration", engine="traditional",
                                  pids=list(map(int, exec_set)),
                                  iteration=st.iterations):
                entry = self.store.get_stacked(tuple(exec_set))
                with self.tracer.span("kernel.eval", engine="traditional",
                                      pids=list(map(int, exec_set))) as ksp:
                    if not self._eval_called:
                        self._eval_called = True
                        ksp.set(first_call=True)
                        self.profiler.attribute_kernel(
                            ("traditional", "veval"),
                            *step_shape(cfg, entry.part, self.store.owner, self.p))
                    loops0 = self.batched_iters
                    in_rows, in_step, in_valid = lane_inputs(
                        [batches[i] for _, i in real], cfg.cap, cfg.q_pad,
                        self.device)
                    res = self._evaluate(
                        entry, plans, [plan.n_steps], [pos for pos, _ in real],
                        [0] * len(real), in_rows, in_step, in_valid,
                        [seeds[i] for _, i in real])
                    outs, landed = lane_outputs(res)
                    loops = self.batched_iters - loops0
                    if self.tracer.enabled:
                        ksp.set(landed=landed, candidates=ranked_slots(
                            cfg, entry.part, len(real), loops))
                    self.profiler.stamp_kernel(ksp, ("traditional", "veval"),
                                               loops)
                    self.profiler.sample_device(ksp, self.store)
            if any(o[0] for o in outs):
                raise RuntimeError("evaluator buffer overflow; raise cap")
            for (pos, _), (_, *rest) in zip(real, outs):
                # merge IMA_i -> FAA/IMA (order-insensitive)
                absorb_eval_outputs(st, exec_set[pos], self.pg.k, *rest)

        answers = truncate_answers(st.unique_answers(), max_answers)
        delta = self.store.stats - load0
        stats = RunStats(query=plan.query.name, scheme=self.pg.scheme,
                         heuristic=heuristic,
                         loads=list(st.loads),
                         l_ideal=l_ideal_for_plan(self.pg, plan),
                         n_answers=int(answers.shape[0]),
                         iterations=st.iterations,
                         answers_requested=max_answers,
                         cold_loads=delta.cold_loads,
                         warm_loads=delta.warm_loads,
                         prefetch_hits=delta.prefetch_hits,
                         disk_reads=delta.disk_reads,
                         read_ahead_hits=delta.read_ahead_hits,
                         bytes_cold=delta.bytes_cold,
                         bytes_prefetched=delta.bytes_prefetched,
                         bytes_disk=delta.bytes_disk,
                         bytes_host=delta.bytes_host)
        return TraditionalMPResult(answers=answers, stats=stats,
                                   state=st, partitions_per_iteration=per_iter)

    def run_request(self, req: RunRequest) -> RunReport:
        """The shared ``QueryRunner`` protocol (see core/runner.py)."""
        res = self.run(req.plan, req.heuristic, seed=req.seed,
                       max_answers=req.max_answers)
        return RunReport(answers=res.answers, stats=res.stats,
                         engine="traditional",
                         extra={"state": res.state,
                                "partitions_per_iteration":
                                    res.partitions_per_iteration})
