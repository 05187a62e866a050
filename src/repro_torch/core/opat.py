"""OPAT — One Partition At a Time query evaluation (paper Sec. 5-7).

The host orchestrator mirrors the paper's PGQP loop exactly:

  1. build the initial SNI from start-label counts per partition,
  2. choose the next partition with the configured heuristic,
  3. run the within-partition evaluator on it (= "load" the partition),
  4. route outgoing continuations into destination IMA files, append
     completed answers to the FAA, update the SNI,
  5. repeat until no partition is eligible.

Partition *loads* (including re-loads of the same partition, Fig. 4c) are
recorded for the load-ratio metrics.  Residency goes through a
``PartitionStore`` (core/store.py): while one partition evaluates, the
engine prefetches the heuristic's runner-up so the next pick's copy
overlaps the current evaluation.

``inner_iters`` counts the evaluator's expansion-loop iterations over the
engine's lifetime (the sum of ``EvalResult.n_iters``): each iteration is
one launch of the fused frontier kernel.  ``batched_iters`` does the same
for ``batched_evaluator()``: the sum of each batched call's loop count,
which is one launch however many queries the call advances.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from ..obs.profile import NULL_PROFILER
from ..obs.trace import NULL_TRACER
from .engine import (EngineConfig, EvalResult, make_batched_evaluator,
                     make_partition_evaluator, plan_to_device, ranked_slots,
                     stack_entry_part, step_shape)
from .graph import PartitionedGraph
from .heuristics import MAX_YIELD, rank_partitions
from .metrics import RunStats, l_ideal_for_plan
from .plan import Plan, PlanArrays
from .runner import RunReport, RunRequest, truncate_answers
from .state import BindingBatch, QueryState
from .store import PartitionStore, StoreEntry


@dataclasses.dataclass
class OPATResult:
    answers: np.ndarray          # [n, q_pad] global-vertex-id rows
    stats: RunStats
    state: QueryState


def absorb_eval_outputs(st: QueryState, pid: int, k: int,
                        comp_rows: np.ndarray, comp_n: int,
                        out_rows: np.ndarray, out_step: np.ndarray,
                        out_dest: np.ndarray, out_n: int) -> None:
    """Route one evaluator call's outputs into a query's bookkeeping state:
    completed rows append to the FAA, outgoing continuations land in their
    destination partitions' IMA files (deduped, paper Fig. 4c), and the
    partition's yield counters update."""
    if comp_n:
        st.add_answers(np.asarray(comp_rows)[:comp_n])
    st.observe_yield(pid, comp_n, out_n)
    if out_n:
        rows = np.asarray(out_rows)[:out_n]
        step = np.asarray(out_step)[:out_n]
        dest = np.asarray(out_dest)[:out_n]
        for q in range(k):
            sel = dest == q
            if sel.any():
                st.ima[q] = st.ima[q].concat(
                    BindingBatch(rows=rows[sel], step=step[sel])).dedup()


def lane_outputs(res: EvalResult) -> Tuple[List[tuple], int]:
    """A lane evaluator's outputs on the host: one sync for the per-lane
    counts, then only the filled rows copied.  Returns one tuple per lane,
    (overflow, comp_rows, comp_n, out_rows, out_step, out_dest, out_n),
    and the rows the call's appends wrote over all lanes."""
    counts = torch.stack([res.overflow.long(), res.comp_n.long(),
                          res.out_n.long(), res.landed], 1).tolist()
    cmax = max((c[1] for c in counts), default=0)
    omax = max((c[2] for c in counts), default=0)
    comp = res.comp_rows[:, :cmax].cpu().numpy()
    orow = res.out_rows[:, :omax].cpu().numpy()
    ostp = res.out_step[:, :omax].cpu().numpy()
    odst = res.out_dest[:, :omax].cpu().numpy()
    return ([(bool(o), comp[i, :c], c, orow[i, :n], ostp[i, :n], odst[i, :n], n)
             for i, (o, c, n, _) in enumerate(counts)],
            sum(c[3] for c in counts))


class OPATEngine:
    """Reusable engine bound to one partitioned graph.

    ``store`` defaults to a private unbounded ``PartitionStore`` on
    ``device`` (None means ``"cuda"``); a ``GraphSession`` passes its own
    so residency (and its hit/miss accounting) is shared across queries,
    and the engine then runs on the store's device.  ``prefetch`` stages
    the heuristic's runner-up partition while the chosen one evaluates.
    """

    def __init__(self, pg: PartitionedGraph, cfg: Optional[EngineConfig] = None,
                 store: Optional[PartitionStore] = None,
                 prefetch: bool = True,
                 tracer: Optional[Any] = None,
                 device: Union[None, str, torch.device] = None,
                 profiler: Optional[Any] = None):
        self.pg = pg
        self.cfg = cfg or EngineConfig()
        assert pg.node_pad > 0, "build_partitions(uniform_pad=True) required"
        self._eval = make_partition_evaluator(pg.node_pad, pg.ell_width,
                                              self.cfg)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.profiler = profiler if profiler is not None else NULL_PROFILER
        self.store = (store if store is not None
                      else PartitionStore(pg, tracer=self.tracer, device=device,
                                          profiler=self.profiler))
        self.device = self.store.device
        self.prefetch = prefetch
        self.inner_iters = 0
        self.batched_iters = 0
        self._beval = None
        self._eval_called = False

    def batched_evaluator(self):
        """The plan-batched partition evaluator: one loaded partition
        advances B pending queries' plans in one call — the JAX package's
        ``vmap`` over the query axis with the partition broadcast, here the
        lane evaluator with one lane per query.

        ``beval(part, g2l, owner, plans, n_steps, in_rows, in_step,
        in_valid, seed_fresh)`` takes the partition as ``store.get`` gives
        it, stacked ``PlanArrays`` [B, ...] and n_steps [B] on the device,
        and inputs with a leading B axis; it returns an ``EvalResult`` with
        a leading B axis and adds its loop count to ``batched_iters``.
        Built lazily: per-query serving never needs it."""
        if self._beval is None:
            lanes = make_batched_evaluator(self.cfg)

            def beval(part, g2l, owner, plans, n_steps, in_rows, in_step,
                      in_valid, seed_fresh) -> EvalResult:
                B = in_rows.shape[0]
                res, loops = lanes(stack_entry_part(part), g2l[None], owner,
                                   plans, n_steps, torch.zeros(B, dtype=torch.long),
                                   torch.arange(B), in_rows, in_step, in_valid,
                                   seed_fresh)
                self.batched_iters += loops
                return res
            self._beval = beval
        return self._beval

    def _run_partition(self, entry: StoreEntry, plan_arrays: PlanArrays,
                       n_steps: int, batch: BindingBatch, seed_fresh: bool,
                       st: QueryState) -> None:
        cfg = self.cfg
        pid = int(entry.key)
        dev = self.device
        chunks: List[BindingBatch] = []
        if batch.n == 0:
            chunks.append(BindingBatch.empty(cfg.q_pad))
        else:
            for i in range(0, batch.n, cfg.cap):
                chunks.append(BindingBatch(rows=batch.rows[i : i + cfg.cap],
                                           step=batch.step[i : i + cfg.cap]))
        for ci, chunk in enumerate(chunks):
            in_rows = np.full((cfg.cap, cfg.q_pad), -1, dtype=np.int32)
            in_step = np.zeros(cfg.cap, dtype=np.int32)
            in_valid = np.zeros(cfg.cap, dtype=bool)
            if chunk.n:
                in_rows[: chunk.n] = chunk.rows
                in_step[: chunk.n] = chunk.step
                in_valid[: chunk.n] = True
            with self.tracer.span("kernel.eval", pid=pid, engine="opat",
                                  rows=int(chunk.n)) as ksp:
                if not self._eval_called:
                    # a key's first call (the process's first also builds
                    # or loads the CUDA step kernel)
                    self._eval_called = True
                    ksp.set(first_call=True)
                    self.profiler.attribute_kernel(
                        ("opat", "eval"),
                        *step_shape(cfg, entry.part, self.store.owner, 1))
                res = self._eval(entry.part, entry.g2l, self.store.owner,
                                 plan_arrays, n_steps,
                                 torch.from_numpy(in_rows).to(dev),
                                 torch.from_numpy(in_step).to(dev),
                                 torch.from_numpy(in_valid).to(dev),
                                 seed_fresh and ci == 0)
                # one device sync for the scalars, inside the span
                overflow, comp_n, out_n, n_iters, landed = (
                    int(v) for v in torch.stack([
                        res.overflow.long(), res.comp_n.long(), res.out_n.long(),
                        res.n_iters.long(), res.landed]).tolist())
                if self.tracer.enabled:
                    ksp.set(landed=landed, candidates=ranked_slots(
                        cfg, entry.part, 1, n_iters))
                self.profiler.stamp_kernel(ksp, ("opat", "eval"), n_iters)
                self.profiler.sample_device(ksp, self.store)
            self.inner_iters += n_iters
            if overflow:
                raise RuntimeError(
                    f"evaluator buffer overflow on partition {pid}; raise "
                    f"EngineConfig.cap (currently {cfg.cap})")
            absorb_eval_outputs(st, pid, self.pg.k,
                                res.comp_rows[:comp_n].cpu().numpy(), comp_n,
                                res.out_rows[:out_n].cpu().numpy(),
                                res.out_step[:out_n].cpu().numpy(),
                                res.out_dest[:out_n].cpu().numpy(), out_n)

    def run(self, plan: Plan, heuristic: str, seed: int = 0,
            max_loads: Optional[int] = None,
            max_answers: Optional[int] = None) -> OPATResult:
        cfg = self.cfg
        assert plan.n_slots <= cfg.q_pad and plan.n_steps <= cfg.s_pad
        rng = np.random.default_rng(seed)
        plan_arrays = plan_to_device(PlanArrays.from_plan(plan, pad_steps=cfg.s_pad),
                                     self.device)
        counts = self.pg.start_label_counts(plan.start_label,
                                            plan.start_value_op,
                                            plan.start_value)
        st = QueryState.initial(self.pg.k, cfg.q_pad, counts,
                                track_answer_keys=max_answers is not None)
        limit = max_loads if max_loads is not None else 64 * self.pg.k
        load0 = self.store.stats.copy()

        while not st.budget_met(max_answers):
            eligible = st.eligible()
            if not eligible:
                break
            if len(st.loads) >= limit:
                raise RuntimeError("OPAT exceeded max partition loads "
                                   f"({limit}); likely a routing bug")
            sni = {p: st.sni_count(p) for p in eligible}
            rates = (st.completion_rates() if heuristic == MAX_YIELD
                     else None)
            ranked = rank_partitions(heuristic, eligible, sni, rng, rates,
                                     tracer=self.tracer)
            pid = ranked[0]
            with self.tracer.span("opat.round", pid=pid,
                                  iteration=st.iterations,
                                  pending_rows=int(st.ima[pid].n)):
                st.loads.append(pid)
                st.iterations += 1
                batch = st.ima[pid]
                st.ima[pid] = BindingBatch.empty(cfg.q_pad)
                seed_fresh = bool(st.fresh_pending[pid])
                st.fresh_pending[pid] = False
                entry = self.store.get(pid)
                # double-buffered streaming: pin pid, then stage the
                # heuristic's runner-up on the side stream while pid
                # evaluates; the pin keeps that staging from evicting the
                # partition the evaluator reads
                with self.store.pinned(pid):
                    if self.prefetch and len(ranked) > 1:
                        self.store.prefetch(ranked[1])
                    self._run_partition(entry, plan_arrays, plan.n_steps,
                                        batch, seed_fresh, st)
                # the unpin may have evicted it: its memory goes now, not
                # after the next round's load
                del entry

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
        return OPATResult(answers=answers, stats=stats, state=st)

    def run_request(self, req: RunRequest) -> RunReport:
        """The shared ``QueryRunner`` protocol (see core/runner.py)."""
        res = self.run(req.plan, req.heuristic, seed=req.seed,
                       max_answers=req.max_answers)
        return RunReport(answers=res.answers, stats=res.stats, engine="opat",
                         extra={"state": res.state})
