"""MapReduceMP — map/reduce-style parallel query evaluation (paper Sec. 9),
on a part mesh (core/mesh.py).

The JAX package runs this engine as one ``shard_map`` SPMD program over a
1-D ``("part",)`` mesh, one device per partition.  Here the P mappers are
spread over the shards of a ``PartMesh``: a shard is a device holding L_s
consecutive mappers as lanes, and every per-mapper tensor of a shard
carries a leading lane axis.  The paper's roles become:

  mapper task (one per partition)   -> a lane of a shard, holding its
                                       partition in the shard's stack of
                                       the store bundle, on its device
  one-edge expansion per iteration  -> ONE frontier-step launch per shard
                                       for all its lanes (kernels/csrc/
                                       fused_frontier.cu on the card; its
                                       plain version on CPU tensors), with
                                       NO within-partition closure
  emit (dest partition id, value)   -> rows tagged with owner[frontier]
  shuffle on partition id           -> quota-based [P, quota] send blocks
                                       per lane, exchanged between shards
                                       (the SPMD program's all_to_all):
                                       each destination receives, for each
                                       of its lanes, every source mapper's
                                       block in global pid order
  reducer (update SNI/IMA/FAA)      -> masked merge into each lane's buffers
  jobtracker SNI merge / stop check -> the shards' counts summed on the
                                       first shard's device (psum), read by
                                       the host once per iteration

The default mesh spreads the mappers over the visible cards: on one card
it is one shard of P lanes, whose shuffle is a transpose on the card.
Shards may share a device, so four one-mapper shards on one card run every
cross-shard step.  A copy between two cards is ``tensor.to(dest,
non_blocking=True)``, which PyTorch orders against both devices' current
streams.

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
heuristics: the lanes' live counts (and for MAX-YIELD their
completed/spawned counters) are gathered as [P] vectors on each device
(all_gather), where every shard takes the same decision.  RANDOM-SN draws
its permutation from a CPU ``torch.Generator`` seeded from (seed,
iteration), copied to each device, not from the JAX package's threefry
stream: under ``m_limit < P`` it gives the same answers, not the same
iteration counts.

Every order-sensitive step (the selection, the free-slot placement, the
grouping by destination, the shuffle's receive order and the heuristic's
ranks) is a stable sort or a fixed order, so row placement, iteration
counts and the yield counters equal the SPMD program's exactly, on every
mesh.  Writes the SPMD program drops (``mode="drop"``) land in one trash
row at the end of each lane's buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

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
from .mesh import PartMesh, default_part_mesh
from .metrics import RunStats, l_ideal_for_plan
from .plan import Plan, PlanArrays
from .runner import RunReport, RunRequest, truncate_answers
from .store import PartitionStore, StoreEntry

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


def _gather(xs: List[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """The shards' per-lane vectors as one [P] vector on ``dev``."""
    if len(xs) == 1:
        return xs[0]
    return torch.cat([x.to(dev, non_blocking=True) for x in xs])


class _Shard:
    """One shard's run: its L lanes' work rows, FAA, flags and counters on
    its device, and the frontier step's invariants and output buffers (its
    own, so two shards on one device alias nothing).  ``lo`` is the global
    id of its first mapper."""

    def __init__(self, cfg: EngineConfig, P: int, quota: int, lo: int,
                 entry: StoreEntry, owner: torch.Tensor, plan: PlanArrays,
                 n_steps: int, budgeted: bool):
        Q, S, CAP = cfg.q_pad, cfg.s_pad, cfg.cap
        part, g2l = entry.part, entry.g2l
        self.dev = dev = owner.device
        self.L = L = g2l.shape[0]
        self.lo, self.P, self.quota, self.budgeted = lo, P, quota, budgeted
        self.Q, self.S, self.CAP = Q, S, CAP
        self.g2l, self.owner, self.plan, self.n_steps = g2l, owner, plan, n_steps
        self.V = owner.shape[0]
        Np = part["node_label"].shape[1]
        W = part["ell_dst"].shape[2]
        self.WT = WT = CAP + Np          # work rows per lane; row WT is trash
        self.EB = EB = min(cfg.expand_block, WT)
        self.kfree = min(EB * W, WT)     # free slots the keep-rows can take
        self.kfree2 = min(P * quota, WT)  # free slots the received rows can take
        i32, i64 = torch.int32, torch.int64
        self.lanes = torch.arange(L, device=dev)[:, None]
        self.n_core = part["n_core"].to(i64)

        # the step's loop-invariant inputs (one plan for every lane; a
        # lane's partition is its row of the shard's stack) and its output
        # buffers: once per run
        self.step_in = kops.step_invariants(
            [part[k] for k in _ELL_TABLES], g2l, owner,
            dataclasses.replace(plan, **{f: getattr(plan, f).expand(L, S)
                                         for f in _PLAN_TENSOR_FIELDS
                                         if getattr(plan, f).dim() == 1}),
            torch.arange(L, device=dev), part["n_core"], n_steps)
        self.step_out = kops.step_outputs(L, EB, W, Q, dev)

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
        self.rows_full = torch.cat(
            [seed_rows, torch.full((L, CAP + 1, Q), -1, dtype=i32, device=dev)], 1)
        self.step_full = torch.zeros((L, WT + 1), dtype=i32, device=dev)
        self.valid_full = torch.cat(
            [start_ok, torch.zeros((L, CAP + 1), dtype=torch.bool, device=dev)], 1)
        self.rows = self.rows_full[:, :WT]
        self.step = self.step_full[:, :WT]
        self.valid = self.valid_full[:, :WT]

        # single-node queries: seeds may already be complete
        self.faa = torch.full((L, CAP + 1, Q), -1, dtype=i32, device=dev)
        done0 = self.valid & (self.step >= n_steps)
        self.faa_n = self.append_faa(done0, self.rows,
                                     torch.zeros(L, dtype=i64, device=dev)).clamp(max=CAP)
        self.valid &= ~done0
        self.overflow = torch.zeros(L, dtype=torch.bool, device=dev)
        self.count_unique()
        self.comp = self.faa_n.clone()
        self.spawn = torch.zeros(L, dtype=i64, device=dev)

    def count_unique(self) -> None:
        self.uniq = (unique_rows(self.faa[:, :self.CAP], self.faa_n) if self.budgeted
                     else self.faa_n)

    def frontier_info(self):
        """[L, WT] masks of live rows whose next frontier vertex is core in
        the lane's partition (act) or not (pend), the local index of that
        vertex and its global id."""
        src = self.plan.src_slot[self.step.clamp(0, self.S - 1).long()].long()
        fg = self.rows.gather(2, src[:, :, None])[:, :, 0]
        lidx = torch.where(fg >= 0, self.g2l.gather(1, fg.clamp(0, self.V - 1).long()), -1)
        local = (lidx >= 0) & (lidx < self.n_core[:, None])
        live = self.valid & (self.step < self.n_steps)
        return live & local, live & ~local, lidx, fg

    def free_slots(self, k: int) -> torch.Tensor:
        """Each lane's first k free work slots, lowest index first."""
        return torch.sort((~self.valid).to(torch.uint8), dim=1, descending=True,
                          stable=True).indices[:, :k]

    def place(self, mask, free, k, new_rows, new_step) -> None:
        """Write the masked rows, in order, into the lanes' free slots (the
        trash row past k of them)."""
        pos = torch.cumsum(mask, 1) - 1
        tgt = torch.where(mask & (pos < k), free.gather(1, pos.clamp(0, k - 1)), self.WT)
        flat = (tgt + self.lanes * (self.WT + 1)).reshape(-1)
        self.rows_full.view(-1, self.Q)[flat] = new_rows.reshape(-1, self.Q)
        self.step_full.view(-1)[flat] = new_step.reshape(-1)
        self.valid_full.view(-1)[flat] = True

    def append_faa(self, done, new_rows, faa_n):
        cnt = torch.cumsum(done, 1) - 1
        tgt = faa_n[:, None] + cnt
        tgt = torch.where(done & (tgt < self.CAP), tgt, self.CAP)
        self.faa.view(-1, self.Q)[(tgt + self.lanes * (self.CAP + 1)).reshape(-1)] = \
            new_rows.reshape(-1, self.Q)
        return faa_n + done.sum(1)

    def map(self, act, lidx) -> None:
        """ONE-edge expansion of up to EB active rows a lane, in one step
        launch for the shard: completions go to the FAA, and every
        continuing row stays local until the shuffle (keep | out)."""
        sel = torch.sort(act.to(torch.uint8), dim=1, descending=True,
                         stable=True).indices[:, :self.EB]
        m = act.gather(1, sel)
        self.valid.scatter_(1, sel, self.valid.gather(1, sel) & ~m)
        _, _, done, keep, outm, _, nr, ns = kops.frontier_step(
            self.step_in, self.rows_full, self.step_full, lidx, sel, m, self.step_out)

        new_n = self.append_faa(done, nr, self.faa_n)
        self.overflow |= new_n > self.CAP
        self.faa_n = new_n.clamp(max=self.CAP)
        self.count_unique()
        # yield observations: completions here vs continuations spawned
        # into another partition (the step's out class)
        self.comp += done.sum(1)
        self.spawn += outm.sum(1)

        keep = keep | outm
        free = self.free_slots(self.kfree)
        self.overflow |= keep.sum(1) > (~self.valid).sum(1)
        self.place(keep, free, self.kfree, nr, ns)

    def send(self) -> torch.Tensor:
        """The shuffle's send side: each lane's first ``quota`` pending
        rows for each destination mapper, in source order, invalidated
        locally.  Returns the blocks as [P, L, quota, Q + 2] int32 (row,
        step, sendable), destination first, so one destination shard's
        blocks are one contiguous slice."""
        L, P, quota, WT, Q = self.L, self.P, self.quota, self.WT, self.Q
        PQ = P * quota
        dev = self.dev
        _, pend, _, fg = self.frontier_info()
        dest = torch.where(pend, self.owner[fg.clamp(0, self.V - 1).long()], P)
        sdest, order = torch.sort(dest, dim=1, stable=True)
        grp_start = torch.searchsorted(
            sdest, torch.arange(P + 1, dtype=sdest.dtype, device=dev)
            .expand(L, P + 1).contiguous())
        # the first `quota` rows of each destination group: send slot
        # [dest, r] holds the group's r-th row in source order
        gpos = grp_start[:, :P, None] + torch.arange(quota, device=dev)
        ok = (gpos < grp_start[:, 1:, None]).reshape(L, PQ)
        src = order.gather(1, gpos.clamp(max=WT - 1).reshape(L, PQ))
        block = torch.cat(
            [torch.where(ok[:, :, None], self.rows.gather(1, src[:, :, None].expand(L, PQ, Q)),
                         -1),
             torch.where(ok, self.step.gather(1, src), 0)[:, :, None],
             ok[:, :, None].to(torch.int32)], 2)
        # invalidate sent rows locally
        sent = torch.where(ok, src, WT)
        self.valid_full.view(-1)[(sent + self.lanes * (WT + 1)).reshape(-1)] = False
        return block.view(L, P, quota, Q + 2).transpose(0, 1).contiguous()

    def receive(self, recv: torch.Tensor) -> None:
        """The reduce: ``recv`` [L, P*quota, Q + 2] (each lane's blocks from
        every source mapper in global pid order) merged into free local
        slots; a lane with too few free slots is flagged."""
        Q = self.Q
        ok = recv[:, :, Q + 1] != 0
        free2 = self.free_slots(self.kfree2)
        self.overflow |= ok.sum(1) > (~self.valid).sum(1)
        self.place(ok, free2, self.kfree2, recv[:, :, :Q], recv[:, :, Q])


class MapReduceMPEngine:
    """One partition per mapper (P = ``pg.k``), the mappers spread over the
    shards of ``mesh`` (core/mesh.py; None: ``default_part_mesh`` on the
    store's device, one shard of P lanes on one card).

    ``quota_per_dest`` (rows a lane may send each destination per
    iteration) defaults to ``max(8, cap // (4P))`` and ``m_limit`` (lanes
    that expand per iteration) to P.  ``store`` defaults to a private
    unbounded ``PartitionStore`` on ``device`` (None means the mesh's first
    device, or ``"cuda"``); each run stages the stacked bundle through it,
    one stack per shard, cold the first time and warm after.
    ``batched_iters`` sums the iterations of every run and
    ``step_launches`` the frontier-step launches: one per shard an
    iteration."""

    def __init__(self, pg: PartitionedGraph,
                 cfg: Optional[EngineConfig] = None,
                 quota_per_dest: Optional[int] = None,
                 m_limit: Optional[int] = None,
                 heuristic: str = MAX_SN,
                 max_outer_iters: int = 4096,
                 store: Optional[PartitionStore] = None,
                 tracer: Optional[Any] = None,
                 device: Union[None, str, torch.device] = None,
                 profiler: Optional[Any] = None,
                 mesh: Optional[PartMesh] = None):
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
        if store is None and device is None and mesh is not None:
            device = mesh.shards[0].device
        self.store = (store if store is not None
                      else PartitionStore(pg, tracer=self.tracer, device=device,
                                          profiler=self.profiler))
        self.device = self.store.device
        self.mesh = mesh if mesh is not None else default_part_mesh(self.P, self.device)
        if self.mesh.k != self.P:
            raise ValueError(f"MapReduceMP needs one mapper per partition (k={self.P}, "
                             f"mesh of {self.mesh.k}); repartition or resize the mesh")
        if self.mesh.shards[0].device.type != self.device.type:
            raise ValueError(f"a mesh on {self.mesh.shards[0].device.type} cannot "
                             f"serve a store on {self.device.type}")
        self.batched_iters = 0
        self.step_launches = 0
        self._eval_called = False

    def shuffle_bytes(self) -> Dict[str, int]:
        """Bytes the shuffle moves each iteration between distinct shards
        and between distinct devices: every ordered pair exchanges
        L_src x L_dst blocks of ``quota`` rows of Q + 2 int32."""
        block = self.quota * (self.cfg.q_pad + 2) * 4
        sh = self.mesh.shards
        pairs = [(a, b) for i, a in enumerate(sh) for j, b in enumerate(sh) if i != j]
        return {"shards": sum(len(a.pids) * len(b.pids) for a, b in pairs) * block,
                "devices": sum(len(a.pids) * len(b.pids) for a, b in pairs
                               if a.device != b.device) * block}

    # -- the mesh program -----------------------------------------------------

    def _random_keys(self, seed: int, it: int, cache: dict,
                     dev: torch.device) -> torch.Tensor:
        """RANDOM-SN's permutation of the P lanes at iteration ``it``, from a
        CPU generator seeded from (seed, it), so every device and the CPU
        draw the same.  They are drawn on the host ``_PERM_BLOCK``
        iterations at a time and copied to each device once per block."""
        block = it // _PERM_BLOCK
        if cache.get("block") != block:
            perms = []
            for i in range(block * _PERM_BLOCK, (block + 1) * _PERM_BLOCK):
                g = torch.Generator().manual_seed(((seed & 0xFFFFFFFF) << 32) | i)
                perms.append(torch.randperm(self.P, generator=g))
            cache.update(block=block, host=torch.stack(perms), on={})
        on = cache["on"]
        if dev not in on:
            on[dev] = cache["host"].to(dev)
        return on[dev][it % _PERM_BLOCK]

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
            key = torch.where(act_sni > 0,
                              self._random_keys(seed, it, perms, act_sni.device), 2**30)
        rank = torch.argsort(torch.argsort(key, stable=True), stable=True)
        return rank < self.m_limit

    def _gate(self, shards: List[_Shard], acts, seed, it, perms) -> list:
        """Each shard's [L_s] lanes that expand this iteration: the [P]
        live counts (and MAX-YIELD's counters) gathered on each device,
        the same decision taken there, and the shard's slice of it."""
        sni = [a.sum(1) for a in acts]
        yld = self._hid == 3
        decided: Dict[torch.device, torch.Tensor] = {}
        out = []
        for sh in shards:
            chosen = decided.get(sh.dev)
            if chosen is None:
                chosen = decided[sh.dev] = self._chosen(
                    _gather(sni, sh.dev),
                    _gather([s.comp for s in shards], sh.dev) if yld else None,
                    _gather([s.spawn for s in shards], sh.dev) if yld else None,
                    seed, it, perms)
            out.append(chosen[sh.lo:sh.lo + sh.L])
        return out

    def _run_mesh(self, entries, owners, plans, n_steps: int, seed: int,
                  budget: int):
        """The SPMD program's ``device_fn`` over every shard.  Returns the
        shards (their FAA, counters and flags on their devices) and the
        iteration count."""
        P, QC = self.P, self.cfg.q_pad + 2
        shards, lo = [], 0
        for entry, owner, plan in zip(entries, owners, plans):
            shards.append(_Shard(self.cfg, P, self.quota, lo, entry, owner, plan,
                                 n_steps, budget < _NO_BUDGET))
            lo += shards[-1].L
        head = shards[0].dev
        perms: dict = {}

        it = 0
        while True:
            fronts = [sh.frontier_info() for sh in shards]
            # the jobtracker's stop test: live rows and unique answers over
            # all lanes, summed on the first shard's device, in one host read
            counts = [torch.stack([(act | pend).sum(), sh.uniq.sum()])
                      for sh, (act, pend, _, _) in zip(shards, fronts)]
            total, got = (counts[0] if len(counts) == 1 else
                          torch.stack([c.to(head) for c in counts]).sum(0)).tolist()
            if not (total > 0 and got < budget and it < self.max_outer_iters):
                break

            # -- heuristic gating when m_limit < P (paper Sec. 9.2) --
            acts = [f[0] for f in fronts]
            if self.m_limit < P:
                acts = [a & ch[:, None]
                        for a, ch in zip(acts, self._gate(shards, acts, seed, it, perms))]

            # -- map: one step launch per shard --
            with record_function("mapreduce.map"):
                for sh, act, front in zip(shards, acts, fronts):
                    sh.map(act, front[2])

            # -- shuffle: every shard's send blocks, then each destination
            # shard receives its lanes' blocks from every source mapper in
            # global pid order (shards hold consecutive mappers) --
            with record_function("mapreduce.shuffle"):
                sends = [sh.send() for sh in shards]
                for d in shards:
                    blocks = [s[d.lo:d.lo + d.L].to(d.dev, non_blocking=True)
                              for s in sends]
                    recv = blocks[0] if len(blocks) == 1 else torch.cat(blocks, 1)
                    d.receive(recv.reshape(d.L, P * self.quota, QC))
            it += 1

        return shards, it

    def run(self, plan: Plan, seed: int = 0,
            max_answers: Optional[int] = None) -> MapReduceMPResult:
        cfg = self.cfg
        assert plan.n_slots <= cfg.q_pad and plan.n_steps <= cfg.s_pad
        pa = PlanArrays.from_plan(plan, pad_steps=cfg.s_pad)
        plans = {d: plan_to_device(pa, d) for d in self.mesh.devices}
        budget = _NO_BUDGET if max_answers is None else min(int(max_answers),
                                                            _NO_BUDGET)
        load0 = self.store.stats.copy()
        # the job-start load: the stacked bundle placed over the mesh, one
        # stack per shard on its device, and the owner table on each device
        entry = self.store.get_stacked(tuple(range(self.P)), device=self.mesh)
        shards = self.mesh.shards
        owners = [self.store.owner_on(sh.device) for sh in shards]
        with self.tracer.span("kernel.eval", engine="mapreduce", n_parts=self.P) as ksp:
            if not self._eval_called:
                self._eval_called = True
                ksp.set(first_call=True)
                self.profiler.attribute_kernel(
                    ("mapreduce", "eval"),
                    *step_shape(cfg, entry.shards[0].part, owners[0], self.mesh.lanes[0]),
                    lanes=self.mesh.lanes)
            runs, n_iter = self._run_mesh(entry.shards, owners,
                                          [plans[sh.device] for sh in shards],
                                          plan.n_steps, seed, budget)
            self.batched_iters += n_iter
            self.step_launches += n_iter * len(runs)
            head = runs[0].dev
            # the overflow flags are read once, after the loop
            flags = _gather([r.overflow for r in runs], head).cpu().numpy()
            faa_n = torch.cat([r.faa_n.cpu() for r in runs]).numpy()
            faa = torch.cat([r.faa[:, :cfg.cap].cpu() for r in runs]).numpy()
            # one step launch per shard an iteration
            self.profiler.stamp_kernel(ksp, ("mapreduce", "eval"), n_iter * len(runs))
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
            completed_from=torch.cat([r.comp.cpu() for r in runs]).numpy().astype(np.int64),
            spawned_from=torch.cat([r.spawn.cpu() for r in runs]).numpy().astype(np.int64))

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
