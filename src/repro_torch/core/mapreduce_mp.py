"""MapReduceMP — map/reduce-style parallel query evaluation (paper Sec. 9),
on one device as a *virtual mesh* of P lanes.

The JAX package runs this engine as one ``shard_map`` SPMD program with
one device per partition.  Here the P mappers are P lanes of one device:
every per-mapper tensor carries a leading lane axis, and the collectives
become tensor operations on it:

  mapper task (one per partition)   -> lane p, holding partition p of the
                                       stacked store bundle
  one-edge expansion per iteration  -> ONE frontier-step launch for all P
                                       lanes (kernels/csrc/fused_frontier.cu
                                       on the card; its plain version on
                                       CPU tensors), with NO within-
                                       partition closure
  emit (dest partition id, value)   -> rows tagged with owner[frontier]
  shuffle on partition id           -> a quota-based [P, P, quota] transpose
                                       (the SPMD program's all_to_all)
  reducer (update SNI/IMA/FAA)      -> masked merge into each lane's buffers
  jobtracker SNI merge / stop check -> sums over lanes (psum), read by the
                                       host once per iteration

The iteration loop is a Python loop; the one host read per iteration is
the stop test (live rows over all lanes, unique answers over all lanes),
so the loop ends on the same iteration as the SPMD ``while_loop``.  The
answer budget counts UNIQUE answers on the device (each lane's distinct
FAA rows, by an exact lexicographic sort — duplicates of an answer always
land on the lane owning its last frontier vertex, so lane counts add up).

Backpressure: rows whose destination quota is full stay in the local
buffer and are re-offered next iteration.  An overflow of any buffer sets
a per-lane flag that ``run`` reads once after the loop and raises on.

When fewer mappers than partitions are available (``m_limit < P``),
expansion is gated to the top-m lanes per iteration under the SN
heuristics, ranked on the device from the lanes' live counts and (for
MAX-YIELD) their completed/spawned counters.  RANDOM-SN draws its
permutation from a ``torch.Generator`` seeded from (seed, iteration), not
from the JAX package's threefry stream: under ``m_limit < P`` it gives the
same answers, not the same iteration counts.

Every order-sensitive step (the selection, the free-slot placement, the
grouping by destination and the heuristic's ranks) is a stable sort, so
row placement, iteration counts and the yield counters equal the SPMD
program's exactly.  Writes the SPMD program drops (``mode="drop"``) land
in one trash row at the end of each lane's buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import numpy as np
import torch
from torch.profiler import record_function

from ..kernels import ops as kops
from ..kernels import ref as kref
from ..obs.profile import NULL_PROFILER
from ..obs.trace import NULL_TRACER
from .engine import (_ELL_TABLES, _PLAN_TENSOR_FIELDS, EngineConfig, plan_to_device,
                     step_shape)
from .graph import WILDCARD, PartitionedGraph
from .heuristics import MAX_SN, MAX_YIELD, MIN_SN, RANDOM_SN
from .metrics import RunStats, l_ideal_for_plan
from .plan import Plan, PlanArrays
from .runner import RunReport, RunRequest, truncate_answers
from .store import PartitionStore

# "no budget" sentinel of the answer-count stop test
_NO_BUDGET = 2**31 - 1
_INT32_MAX = 2**31 - 1
# RANDOM-SN permutations drawn per host batch (see _random_keys)
_PERM_BLOCK = 64


@dataclasses.dataclass
class MapReduceMPResult:
    answers: np.ndarray
    stats: RunStats
    n_iterations: int
    # per-partition yield counters (the MAX-YIELD observations), surfaced
    # for the session profile
    completed_from: np.ndarray = None   # [P] int64
    spawned_from: np.ndarray = None     # [P] int64


def _heuristic_id(h: str) -> int:
    return {MAX_SN: 0, MIN_SN: 1, RANDOM_SN: 2, MAX_YIELD: 3}[h]


def unique_rows(faa: torch.Tensor, faa_n: torch.Tensor) -> torch.Tensor:
    """Per lane, the number of distinct rows among the first ``faa_n[l]``
    rows of ``faa`` [L, N, Q]: a lexicographic sort by Q iterated stable
    sorts (rows past ``faa_n`` sentinel-filled with INT32_MAX, so they sort
    last), then the rows that differ from their predecessor.  Exact (no
    hashing) and without a host sync.  Returns [L] int64."""
    L, N, Q = faa.shape
    valid = torch.arange(N, device=faa.device)[None, :] < faa_n[:, None]
    rows = torch.where(valid[:, :, None], faa, _INT32_MAX)
    order = torch.arange(N, device=faa.device).expand(L, N)
    for q in range(Q - 1, -1, -1):
        keys = rows[:, :, q].gather(1, order)
        order = order.gather(1, torch.sort(keys, dim=1, stable=True).indices)
    srt = rows.gather(1, order[:, :, None].expand(L, N, Q))
    first = torch.ones((L, N), dtype=torch.bool, device=faa.device)
    first[:, 1:] = (srt[:, 1:] != srt[:, :-1]).any(2)
    return (valid.gather(1, order) & first).sum(1)


class MapReduceMPEngine:
    """One partition per lane (P = ``pg.k``), all lanes on one device.

    ``quota_per_dest`` (rows a lane may send each destination per
    iteration) defaults to ``max(8, cap // (4P))`` and ``m_limit`` (lanes
    that expand per iteration) to P.  ``store`` defaults to a private
    unbounded ``PartitionStore`` on ``device`` (None means ``"cuda"``);
    each run stages the stacked [P, ...] bundle through it, cold the first
    time and warm after.  ``batched_iters`` sums the iterations of every
    run: one frontier-step launch each."""

    def __init__(self, pg: PartitionedGraph,
                 cfg: Optional[EngineConfig] = None,
                 quota_per_dest: Optional[int] = None,
                 m_limit: Optional[int] = None,
                 heuristic: str = MAX_SN,
                 max_outer_iters: int = 4096,
                 store: Optional[PartitionStore] = None,
                 tracer: Optional[Any] = None,
                 device: Union[None, str, torch.device] = None,
                 profiler: Optional[Any] = None):
        self.pg = pg
        self.cfg = cfg or EngineConfig()
        self.P = pg.k
        self.quota = quota_per_dest or max(8, self.cfg.cap // (4 * self.P))
        self.m_limit = m_limit if m_limit is not None else self.P
        self._hid = _heuristic_id(heuristic)
        self.heuristic = heuristic
        self.max_outer_iters = max_outer_iters
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.profiler = profiler if profiler is not None else NULL_PROFILER
        self.store = (store if store is not None
                      else PartitionStore(pg, tracer=self.tracer, device=device,
                                          profiler=self.profiler))
        self.device = self.store.device
        self.batched_iters = 0
        self._eval_called = False

    # -- the virtual-mesh program ---------------------------------------------

    def _random_keys(self, seed: int, it: int, cache: dict) -> torch.Tensor:
        """RANDOM-SN's permutation of the P lanes at iteration ``it``, from a
        CPU generator seeded from (seed, it), so CPU and card runs draw the
        same.  They are drawn on the host ``_PERM_BLOCK`` iterations at a
        time and copied to the device once per block."""
        block = it // _PERM_BLOCK
        if block not in cache:
            perms = []
            for i in range(block * _PERM_BLOCK, (block + 1) * _PERM_BLOCK):
                g = torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | i)
                perms.append(torch.randperm(self.P, generator=g))
            cache.clear()
            cache[block] = torch.stack(perms).to(self.device)
        return cache[block][it % _PERM_BLOCK]

    def _chosen(self, act_sni, comp, spawn, seed, it, perms) -> torch.Tensor:
        """[P] bool: the lanes that expand this iteration (the top m_limit
        under the heuristic, by dense ranks from two stable argsorts)."""
        if self._hid == 0:          # MAX-SN: most start/continuation rows
            key = -act_sni
        elif self._hid == 1:        # MIN-SN among non-empty
            key = torch.where(act_sni > 0, act_sni, 2**30)
        elif self._hid == 3:        # MAX-YIELD: SNI x completion rate, f32
            rate = ((comp.float() + 1.0) / ((comp + spawn).float() + 2.0))
            key = -(act_sni.float() * rate)
        else:                       # RANDOM among non-empty
            key = torch.where(act_sni > 0, self._random_keys(seed, it, perms),
                              2**30)
        rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
        return rank < self.m_limit

    def _run_lanes(self, part, g2l, owner, plan: PlanArrays, n_steps: int,
                   seed: int, budget: int):
        """The SPMD program's ``device_fn`` over all lanes.  Returns (faa
        [P, CAP, Q], faa_n [P], overflow [P], iterations, completed [P],
        spawned [P]) with the tensors on the device."""
        cfg = self.cfg
        Q, S, CAP = cfg.q_pad, cfg.s_pad, cfg.cap
        P, quota = self.P, self.quota
        dev = owner.device
        V = owner.shape[0]
        Np = part["node_label"].shape[1]
        W = part["ell_dst"].shape[2]
        WT = CAP + Np                 # work rows per lane; row WT is trash
        EB = min(cfg.expand_block, WT)
        kfree = min(EB * W, WT)       # free slots the keep-rows can take
        PQ = P * quota
        kfree2 = min(PQ, WT)          # free slots the received rows can take
        i32, i64 = torch.int32, torch.int64
        lanes = torch.arange(P, device=dev)[:, None]
        n_core = part["n_core"].to(i64)

        # the step's loop-invariant inputs (one plan for every lane) and its
        # output buffers: once per run
        step_in = kops.step_invariants(
            [part[k] for k in _ELL_TABLES], g2l, owner,
            dataclasses.replace(plan, **{f: getattr(plan, f).expand(P, S)
                                         for f in _PLAN_TENSOR_FIELDS
                                         if getattr(plan, f).dim() == 1}),
            torch.arange(P, device=dev), part["n_core"], n_steps)
        step_out = kops.step_outputs(P, EB, W, Q, dev)

        def frontier_info(rows, step, valid):
            """[P, WT] masks of live rows whose next frontier vertex is core
            in the lane's partition (act) or not (pend), the local index
            of that vertex and its global id."""
            src = plan.src_slot[step.clamp(0, S - 1).long()].long()
            fg = rows.gather(2, src[:, :, None])[:, :, 0]
            lidx = torch.where(fg >= 0, g2l.gather(1, fg.clamp(0, V - 1).long()), -1)
            local = (lidx >= 0) & (lidx < n_core[:, None])
            live = valid & (step < n_steps)
            return live & local, live & ~local, lidx, fg

        def free_slots(valid, k):
            """Each lane's first k free work slots, lowest index first."""
            return torch.sort((~valid).to(torch.uint8), dim=1, descending=True,
                              stable=True).indices[:, :k]

        def place(mask, free, k, new_rows, new_step):
            """Write the masked rows, in order, into the lanes' free slots
            (the trash row past k of them)."""
            pos = torch.cumsum(mask, 1) - 1
            tgt = torch.where(mask & (pos < k), free.gather(1, pos.clamp(0, k - 1)), WT)
            flat = (tgt + lanes * (WT + 1)).reshape(-1)
            rows_full.view(-1, Q)[flat] = new_rows.reshape(-1, Q)
            step_full.view(-1)[flat] = new_step.reshape(-1)
            valid_full.view(-1)[flat] = True

        def append_faa(done, new_rows, faa_n):
            cnt = torch.cumsum(done, 1) - 1
            tgt = faa_n[:, None] + cnt
            tgt = torch.where(done & (tgt < CAP), tgt, CAP)
            faa.view(-1, Q)[(tgt + lanes * (CAP + 1)).reshape(-1)] = new_rows.reshape(-1, Q)
            return faa_n + done.sum(1)

        def shuffle():
            """The shuffle (a quota-based all_to_all on destination pid) and
            the reduce (received rows merged into free local slots), in
            place.  Returns each lane's merge-overflow flag."""
            _, pend, _, fg = frontier_info(rows, step, valid)
            dest = torch.where(pend, owner[fg.clamp(0, V - 1).long()], P)
            sdest, order = torch.sort(dest, dim=1, stable=True)
            grp_start = torch.searchsorted(
                sdest, torch.arange(P + 1, dtype=sdest.dtype, device=dev)
                .expand(P, P + 1).contiguous())
            # the first `quota` rows of each destination group: send slot
            # [dest, r] holds the group's r-th row in source order
            gpos = grp_start[:, :P, None] + torch.arange(quota, device=dev)
            sendable = gpos < grp_start[:, 1:, None]                 # [P, P, quota]
            src = order.gather(1, gpos.clamp(max=WT - 1).reshape(P, PQ))
            send_rows = torch.where(sendable.reshape(P, PQ, 1),
                                    rows.gather(1, src[:, :, None].expand(P, PQ, Q)), -1)
            send_step = torch.where(sendable.reshape(P, PQ), step.gather(1, src), 0)
            # invalidate sent rows locally
            sent = torch.where(sendable.reshape(P, PQ), src, WT)
            valid_full.view(-1)[(sent + lanes * (WT + 1)).reshape(-1)] = False
            # lane d receives, in source order, each source's block for d
            recv_rows = send_rows.view(P, P, quota, Q).transpose(0, 1).reshape(P, PQ, Q)
            recv_step = send_step.view(P, P, quota).transpose(0, 1).reshape(P, PQ)
            recv_valid = sendable.transpose(0, 1).reshape(P, PQ)
            # reduce
            free2 = free_slots(valid, kfree2)
            ovf = recv_valid.sum(1) > (~valid).sum(1)
            place(recv_valid, free2, kfree2, recv_rows, recv_step)
            return ovf

        # ---- iteration-0 seeding on every partition (all mappers) ----
        node_idx = torch.arange(Np, dtype=i32, device=dev)
        start_ok = ((node_idx[None, :] < part["n_core"][:, None])
                    & ((plan.start_label == WILDCARD)
                       | (part["node_label"] == plan.start_label))
                    & kref.value_pred(plan.start_value_op, part["node_value"],
                                      plan.start_value))
        col = torch.arange(Q, dtype=i32, device=dev)
        seed_rows = torch.where((col == plan.start_slot) & start_ok[:, :, None],
                                part["node_gid"][:, :, None], -1)
        rows_full = torch.cat([seed_rows,
                               torch.full((P, CAP + 1, Q), -1, dtype=i32, device=dev)], 1)
        step_full = torch.zeros((P, WT + 1), dtype=i32, device=dev)
        valid_full = torch.cat([start_ok,
                                torch.zeros((P, CAP + 1), dtype=torch.bool, device=dev)], 1)
        rows, step, valid = rows_full[:, :WT], step_full[:, :WT], valid_full[:, :WT]

        # single-node queries: seeds may already be complete
        faa = torch.full((P, CAP + 1, Q), -1, dtype=i32, device=dev)
        done0 = valid & (step >= n_steps)
        faa_n = append_faa(done0, rows, torch.zeros(P, dtype=i64, device=dev))
        faa_n = faa_n.clamp(max=CAP)
        valid &= ~done0
        overflow = torch.zeros(P, dtype=torch.bool, device=dev)
        budgeted = budget < _NO_BUDGET
        uniq = unique_rows(faa[:, :CAP], faa_n) if budgeted else faa_n
        comp = faa_n.clone()
        spawn = torch.zeros(P, dtype=i64, device=dev)
        perms: dict = {}

        it = 0
        while True:
            act, pend, lidx, _ = frontier_info(rows, step, valid)
            # the jobtracker's stop test: live rows and unique answers over
            # all lanes, in one host read
            total, got = torch.stack([(act | pend).sum(), uniq.sum()]).tolist()
            if not (total > 0 and got < budget and it < self.max_outer_iters):
                break

            # -- heuristic gating when m_limit < P (paper Sec. 9.2) --
            if self.m_limit < P:
                act = act & self._chosen(act.sum(1), comp, spawn, seed, it,
                                         perms)[:, None]

            # -- map: ONE-edge expansion of up to EB active rows a lane --
            with record_function("mapreduce.map"):
                sel = torch.sort(act.to(torch.uint8), dim=1, descending=True,
                                 stable=True).indices[:, :EB]
                m = act.gather(1, sel)
                valid.scatter_(1, sel, valid.gather(1, sel) & ~m)
                _, _, done, keep, outm, _, nr, ns = kops.frontier_step(
                    step_in, rows_full, step_full, lidx, sel, m, step_out)

                new_n = append_faa(done, nr, faa_n)
                overflow |= new_n > CAP
                faa_n = new_n.clamp(max=CAP)
                uniq = unique_rows(faa[:, :CAP], faa_n) if budgeted else faa_n
                # yield observations: completions here vs continuations
                # spawned into another partition (the step's out class)
                comp += done.sum(1)
                spawn += outm.sum(1)

                # ALL continuing rows stay local until the shuffle (keep | out)
                keep = keep | outm
                free = free_slots(valid, kfree)
                overflow |= keep.sum(1) > (~valid).sum(1)
                place(keep, free, kfree, nr, ns)

            with record_function("mapreduce.shuffle"):
                overflow |= shuffle()
            it += 1

        return faa[:, :CAP], faa_n, overflow, it, comp, spawn

    def run(self, plan: Plan, seed: int = 0,
            max_answers: Optional[int] = None) -> MapReduceMPResult:
        cfg = self.cfg
        assert plan.n_slots <= cfg.q_pad and plan.n_steps <= cfg.s_pad
        pa = plan_to_device(PlanArrays.from_plan(plan, pad_steps=cfg.s_pad),
                            self.device)
        budget = _NO_BUDGET if max_answers is None else min(int(max_answers),
                                                            _NO_BUDGET)
        load0 = self.store.stats.copy()
        entry = self.store.get_stacked(tuple(range(self.P)))
        with self.tracer.span("kernel.eval", engine="mapreduce", n_parts=self.P) as ksp:
            if not self._eval_called:
                self._eval_called = True
                ksp.set(first_call=True)
                self.profiler.attribute_kernel(
                    ("mapreduce", "eval"),
                    *step_shape(cfg, entry.part, self.store.owner, self.P))
            faa, faa_n, overflow, n_iter, comp, spawn = self._run_lanes(
                entry.part, entry.g2l, self.store.owner, pa, plan.n_steps,
                seed, budget)
            self.batched_iters += n_iter
            # the overflow flags are read once, after the loop
            flags = overflow.cpu().numpy()
            faa_n = faa_n.cpu().numpy()
            faa = faa.cpu().numpy()
            # one step launch per iteration, for all P lanes
            self.profiler.stamp_kernel(ksp, ("mapreduce", "eval"), n_iter)
            self.profiler.sample_device(ksp, self.store)
        if flags.any():
            raise RuntimeError("MapReduceMP buffer overflow; raise cap/quota")
        rows = [faa[p, : faa_n[p]] for p in range(self.P) if faa_n[p]]
        answers = (np.unique(np.concatenate(rows), axis=0) if rows
                   else np.zeros((0, cfg.q_pad), dtype=np.int32))
        answers = truncate_answers(answers, max_answers)
        delta = self.store.stats - load0
        stats = RunStats(query=plan.query.name, scheme=self.pg.scheme,
                         heuristic=self.heuristic,
                         loads=[], l_ideal=l_ideal_for_plan(self.pg, plan),
                         n_answers=int(answers.shape[0]),
                         iterations=n_iter,
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
        return MapReduceMPResult(
            answers=answers, stats=stats, n_iterations=n_iter,
            completed_from=comp.cpu().numpy().astype(np.int64),
            spawned_from=spawn.cpu().numpy().astype(np.int64))

    def run_request(self, req: RunRequest) -> RunReport:
        """The shared ``QueryRunner`` protocol (see core/runner.py).  The
        heuristic is fixed at construction; a conflicting per-request
        heuristic is an error rather than a silent ignore."""
        if req.heuristic != self.heuristic:
            raise ValueError(
                f"MapReduceMPEngine was built with heuristic "
                f"{self.heuristic!r}; rebuild the engine to run "
                f"{req.heuristic!r}")
        res = self.run(req.plan, seed=req.seed, max_answers=req.max_answers)
        return RunReport(answers=res.answers, stats=res.stats,
                         engine="mapreduce",
                         extra={"n_iterations": res.n_iterations,
                                "completed_from": res.completed_from,
                                "spawned_from": res.spawned_from})
