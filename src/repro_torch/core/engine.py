"""The within-partition evaluator on PyTorch tensors.

One evaluator call processes one partition: it seeds fresh start-node
bindings (when the partition is processed for the first time), expands
all local partial answers breadth-first following the plan, and
classifies every produced row as

  completed  -> appended to the FAA buffer,
  local      -> next frontier vertex owned here; kept in the work buffer,
  outgoing   -> next frontier vertex owned elsewhere; emitted with its
                destination partition id (the paper's PCA/IMA continuation).

All buffers are fixed capacity; saturation sets an ``overflow`` flag the
host checks (never silent).  The per-step expansion evaluates an [EB, W]
tile (EB active bindings x ELLPACK width W) of candidate edges densely in
one step (kernels/fused_frontier.py): from the loop's selection straight
to the routed masks and the new rows, as one CUDA launch on CUDA tensors
and its plain PyTorch version on CPU tensors.  Its loop-invariant inputs
are packed once per evaluator call (``kops.step_invariants``).

The expansion loop is a Python loop with one host sync per iteration (the
"any row still active" test).  Row selection breaks ties the way the
JAX evaluator's ``lax.top_k`` does — lowest index first — through a
stable sort, so iteration counts and row placement match it exactly.
The masked appends (completed, outgoing, and kept rows into the lowest
free work slots) are one op, ``kops.frontier_append``: one CUDA launch
after each step launch that ranks the flags in candidate order and moves
only the rows that land, and the cumsum + scatter form on CPU tensors.
Counts and overflow stay on the device, so no append forces a sync.

Two forms share those rules:

  make_partition_evaluator — one partition, one plan (OPAT's ``submit``).
  make_batched_evaluator   — L independent *lanes*, each with its own
      partition (from a stacked [P, Np, ...] bundle) and its own plan
      (from stacked ``PlanArrays``): the JAX package's three ``vmap``
      forms (TraditionalMP's partition lanes, OPAT's query lanes and the
      scheduler's query x partition lanes) as one native lane axis.  Each
      loop iteration makes ONE fused-kernel launch over all lanes'
      selected rows, and one host sync.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import ref as kref
from .graph import WILDCARD, PartitionArrays
from .plan import PlanArrays

_ELL_TABLES = ("ell_dst", "ell_label", "ell_dir", "ell_dlab", "ell_dval", "ell_dgid")
_PLAN_TENSOR_FIELDS = ("start_slot", "start_label", "start_value_op",
                       "start_value", "src_slot", "dst_slot", "edge_label",
                       "direction", "dst_label", "dst_value_op", "dst_value",
                       "closes_cycle")


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """``None`` means ``"cuda"``.  A CUDA device with no card raises: the
    port never carries on quietly on the CPU; pass ``device="cpu"`` to run
    the kernels' plain versions on the host."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' "
                               "to run the plain versions on the host")
    elif dev.type != "cpu":
        raise ValueError(f"device must be cuda or cpu, got {dev}")
    return dev


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static geometry of the evaluator."""

    q_pad: int = 8            # binding row width (max query nodes)
    s_pad: int = 12           # padded plan length
    cap: int = 4096           # in/out/completed buffer capacity
    expand_block: int = 512   # active rows expanded per loop iteration (EB)
    max_inner_iters: int = 10_000


class EvalResult(NamedTuple):
    comp_rows: torch.Tensor      # [cap, Q] int32
    comp_n: torch.Tensor         # [] int32
    out_rows: torch.Tensor       # [cap, Q] int32
    out_step: torch.Tensor       # [cap] int32
    out_dest: torch.Tensor       # [cap] int32
    out_n: torch.Tensor          # [] int32
    overflow: torch.Tensor       # [] bool
    n_iters: torch.Tensor        # [] int32 expansion-loop iterations
    n_expanded: torch.Tensor     # [] int32 total candidate rows expanded
    landed: torch.Tensor         # [] int64 rows the appends wrote
                                 # (completed + outgoing + kept)


def make_partition_evaluator(node_pad: int, ell_width: int, cfg: EngineConfig):
    """Build the evaluator.

    Geometry-agnostic: the padded node count ``Np`` and ELLPACK width ``W``
    are read off the input tensors (``node_pad`` / ``ell_width`` are
    advisory, kept in the signature for callers that size buffers up
    front).  Runs on the device its inputs live on.
    """

    Q, S = cfg.q_pad, cfg.s_pad
    CAP = cfg.cap

    def _frontier_local(rows, step, valid, plan, n_steps, g2l_row, n_core):
        """active mask + local index of each row's next frontier vertex."""
        s = step.clamp(0, S - 1).long()
        src_slot = plan.src_slot[s]
        fg = rows.gather(1, src_slot.long()[:, None])[:, 0]
        fg_safe = fg.clamp(0, g2l_row.shape[0] - 1).long()
        lidx = torch.where(fg >= 0, g2l_row[fg_safe], -1)
        local = (lidx >= 0) & (lidx < n_core)
        act = valid & (step < n_steps) & local
        return act, lidx, fg

    def evaluate(part: Dict[str, torch.Tensor], g2l_row: torch.Tensor,
                 owner: torch.Tensor, plan: PlanArrays, n_steps: int,
                 in_rows: torch.Tensor, in_step: torch.Tensor,
                 in_valid: torch.Tensor, seed_fresh: bool) -> EvalResult:
        dev = in_rows.device
        n_core = int(part["n_core"])
        n_steps = int(n_steps)
        Np = part["node_label"].shape[0]
        W = part["ell_dst"].shape[1]
        WT = CAP + Np  # work buffer: incoming rows + fresh seeds
        EB = min(cfg.expand_block, WT)  # can't select more rows than exist
        EBW = EB * W
        kfree = min(EBW, WT)

        # the frontier step's loop-invariant inputs and its outputs: once
        # per call
        step_in = kops.step_invariants([part[k] for k in _ELL_TABLES], g2l_row,
                                       owner, plan, 0, n_core, n_steps)
        step_out = kops.step_outputs(1, EB, W, Q, dev)

        # ---- seed fresh start-node bindings (SNI entries with NULL vid) ----
        node_idx = torch.arange(Np, dtype=torch.int32, device=dev)
        start_ok = ((node_idx < n_core)
                    & ((plan.start_label == WILDCARD)
                       | (part["node_label"] == plan.start_label))
                    & kref.value_pred(plan.start_value_op, part["node_value"],
                                 plan.start_value)
                    & bool(seed_fresh))
        col = torch.arange(Q, dtype=torch.int32, device=dev)
        fresh_rows = torch.where((col[None, :] == plan.start_slot) & start_ok[:, None],
                                 part["node_gid"][:, None], -1)
        # one extra trash row at index WT (the plain appends write there)
        wr_full = torch.cat([in_rows, fresh_rows,
                             torch.full((1, Q), -1, dtype=torch.int32, device=dev)])
        ws_full = torch.cat([in_step, torch.zeros(Np + 1, dtype=torch.int32, device=dev)])
        wv_full = torch.cat([in_valid, start_ok,
                             torch.zeros(1, dtype=torch.bool, device=dev)])
        wr, ws, wv = wr_full[:WT], ws_full[:WT], wv_full[:WT]

        # one lane: [1, ...] buffers and views
        st = kops.append_state(1, CAP, Q, max(WT, EBW), dev)
        n_expanded = torch.zeros((), dtype=torch.int64, device=dev)

        # ---- pre-classify: rows already complete, or frontier not local ----
        done0 = wv & (ws >= n_steps)
        act0, _, fg0 = _frontier_local(wr, ws, wv, plan, n_steps, g2l_row, n_core)
        outm0 = wv & ~done0 & ~act0
        dest0 = owner[fg0.clamp(0, owner.shape[0] - 1).long()]
        kops.frontier_append(st, wr[None], ws[None], dest0[None], done0[None],
                             outm0[None])
        wv &= act0

        it = 0
        while it < cfg.max_inner_iters:
            act, lidx, _ = _frontier_local(wr, ws, wv, plan, n_steps, g2l_row, n_core)
            if not bool(act.any()):
                break
            # up to EB active rows, lowest index first (lax.top_k's ties)
            sel = torch.sort(act.to(torch.uint8), descending=True, stable=True)[1][:EB]
            m = act[sel]
            # consume them
            wv[sel] = wv[sel] & ~m

            out = kops.frontier_step(step_in, wr_full[None], ws_full[None],
                                     lidx[None], sel[None], m[None], step_out)
            # keep-rows go into the lowest free work slots
            free = torch.sort((~wv).to(torch.uint8), descending=True,
                              stable=True)[1][:kfree]
            kops.frontier_append(st, out.nr, out.ns, out.dest, out.done,
                                 out.outm, out.keep,
                                 (wr_full[None], ws_full[None], wv_full[None]),
                                 free[None])
            # the two sorts' [WT] indices are not held into the next loop
            del sel, free

            it += 1
            n_expanded = n_expanded + m.sum()

        i32 = torch.int32
        return EvalResult(st.comp_rows[0, :CAP], st.comp_n[0], st.out_rows[0, :CAP],
                          st.out_step[0, :CAP], st.out_dest[0, :CAP], st.out_n[0],
                          st.overflow[0], torch.tensor(it, dtype=i32, device=dev),
                          n_expanded.to(i32), st.landed[0])

    return evaluate


def make_batched_evaluator(cfg: EngineConfig):
    """Build the lane evaluator: L independent evaluations in one call.

    ``evaluate(parts, g2l, owner, plans, n_steps, lane_part, lane_plan,
    in_rows, in_step, in_valid, seed_fresh)`` takes

      parts      stacked partition dict, tables [P, Np, ...], ``n_core`` [P]
      g2l        [P, V] int32, each partition's g2l row
      owner      [V] int32
      plans      stacked ``PlanArrays`` (fields [B] / [B, S]) on the device
      n_steps    [B] int32
      lane_part  [L] partition (index into P) of each lane
      lane_plan  [L] plan (index into B) of each lane
      in_rows    [L, CAP, Q], in_step [L, CAP], in_valid [L, CAP]
      seed_fresh [L] bool

    and returns (``EvalResult`` with a leading L axis, the number of loop
    iterations it ran).  Each lane's result equals the single-partition
    evaluator's on that lane's inputs, as ``jax.vmap`` of the JAX
    evaluator gives them: the loop runs while any lane has active rows; a
    lane with none, or at ``max_inner_iters``, is frozen (its rows masked
    out of the launch, its ``n_iters`` and ``n_expanded`` no longer
    counting).  Selection, appends and overflow are per lane.
    """
    Q, S, CAP = cfg.q_pad, cfg.s_pad, cfg.cap

    def evaluate(parts: Dict[str, torch.Tensor], g2l: torch.Tensor,
                 owner: torch.Tensor, plans: PlanArrays, n_steps,
                 lane_part, lane_plan, in_rows: torch.Tensor,
                 in_step: torch.Tensor, in_valid: torch.Tensor,
                 seed_fresh) -> Tuple[EvalResult, int]:
        dev = in_rows.device
        Np = parts["node_label"].shape[1]
        W = parts["ell_dst"].shape[2]
        V = owner.shape[0]
        L = in_rows.shape[0]
        WT = CAP + Np  # work buffer: incoming rows + fresh seeds
        EB = min(cfg.expand_block, WT)  # can't select more rows than exist
        EBW = EB * W
        kfree = min(EBW, WT)
        i32, i64 = torch.int32, torch.int64

        def lane_tensor(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=dev).reshape(-1)

        lane_part = lane_tensor(lane_part, i64)
        lane_plan = lane_tensor(lane_plan, i64)
        n_core = lane_tensor(parts["n_core"], i32)[lane_part]          # [L]
        nst = lane_tensor(n_steps, i32)[lane_plan]                      # [L]
        plan = dataclasses.replace(plans, **{
            f: getattr(plans, f)[lane_plan] for f in _PLAN_TENSOR_FIELDS})
        g2l_flat = g2l.reshape(-1)
        g2l_off = lane_part * V

        # the frontier step reads the stacked tables as one [P*Np, W] view,
        # each lane's rows offset by its partition: packed once per call
        step_in = kops.step_invariants([parts[k] for k in _ELL_TABLES], g2l,
                                       owner, plan, lane_part, n_core, nst)
        step_out = kops.step_outputs(L, EB, W, Q, dev)

        def frontier_local(rows, step, valid):
            """[L, N] active mask + local index of each row's next frontier
            vertex in its lane's partition."""
            s = step.clamp(0, S - 1).long()
            src = plan.src_slot.gather(1, s).long()
            fg = rows.gather(2, src[:, :, None])[:, :, 0]
            fg_safe = fg.clamp(0, V - 1).long()
            lidx = torch.where(fg >= 0, g2l_flat[fg_safe + g2l_off[:, None]], -1)
            local = (lidx >= 0) & (lidx < n_core[:, None])
            act = valid & (step < nst[:, None]) & local
            return act, lidx, fg

        # ---- seed fresh start-node bindings from each lane's partition ----
        node_idx = torch.arange(Np, dtype=i32, device=dev)
        sf = lane_tensor(seed_fresh, torch.bool)
        start_label = plan.start_label[:, None]
        start_ok = ((node_idx[None, :] < n_core[:, None])
                    & ((start_label == WILDCARD)
                       | (parts["node_label"][lane_part] == start_label))
                    & kref.value_pred(plan.start_value_op[:, None],
                                      parts["node_value"][lane_part],
                                      plan.start_value[:, None])
                    & sf[:, None])
        col = torch.arange(Q, dtype=i32, device=dev)
        fresh_rows = torch.where(
            (col[None, None, :] == plan.start_slot[:, None, None]) & start_ok[:, :, None],
            parts["node_gid"][lane_part][:, :, None], -1)
        # one extra trash row per lane at index WT (the plain appends write there)
        wr_full = torch.cat([in_rows, fresh_rows,
                             torch.full((L, 1, Q), -1, dtype=i32, device=dev)], 1)
        ws_full = torch.cat([in_step, torch.zeros((L, Np + 1), dtype=i32, device=dev)], 1)
        wv_full = torch.cat([in_valid, start_ok,
                             torch.zeros((L, 1), dtype=torch.bool, device=dev)], 1)
        wr, ws, wv = wr_full[:, :WT], ws_full[:, :WT], wv_full[:, :WT]

        st = kops.append_state(L, CAP, Q, max(WT, EBW), dev)
        n_expanded = torch.zeros(L, dtype=i64, device=dev)
        n_iters = torch.zeros(L, dtype=i32, device=dev)

        # ---- pre-classify: rows already complete, or frontier not local ----
        done0 = wv & (ws >= nst[:, None])
        act0, _, fg0 = frontier_local(wr, ws, wv)
        outm0 = wv & ~done0 & ~act0
        dest0 = owner[fg0.clamp(0, V - 1).long()]
        kops.frontier_append(st, wr, ws, dest0, done0, outm0)
        wv &= act0

        loops = 0
        while True:
            act, lidx, _ = frontier_local(wr, ws, wv)
            go = act.any(1) & (n_iters < cfg.max_inner_iters)
            if not bool(go.any()):
                break
            act &= go[:, None]          # frozen lanes select nothing
            # up to EB active rows per lane, lowest index first
            sel = torch.sort(act.to(torch.uint8), dim=1, descending=True,
                             stable=True)[1][:, :EB]
            m = act.gather(1, sel)
            # consume them
            wv.scatter_(1, sel, wv.gather(1, sel) & ~m)

            out = kops.frontier_step(step_in, wr_full, ws_full, lidx, sel, m,
                                     step_out)
            # keep-rows go into each lane's lowest free work slots
            free = torch.sort((~wv).to(torch.uint8), dim=1, descending=True,
                              stable=True)[1][:, :kfree]
            kops.frontier_append(st, out.nr, out.ns, out.dest, out.done,
                                 out.outm, out.keep, (wr_full, ws_full, wv_full),
                                 free)
            # the two sorts' [L, WT] indices are not held into the next loop
            del sel, free

            n_iters += go.to(i32)
            n_expanded = n_expanded + m.sum(1)
            loops += 1

        return EvalResult(st.comp_rows[:, :CAP], st.comp_n, st.out_rows[:, :CAP],
                          st.out_step[:, :CAP], st.out_dest[:, :CAP], st.out_n,
                          st.overflow, n_iters, n_expanded.to(i32), st.landed), loops

    return evaluate


def step_shape(cfg: EngineConfig, part: Dict[str, torch.Tensor],
               owner: torch.Tensor, lanes: int) -> Tuple[int, ...]:
    """The frontier step's shapes (L, EB, W, Q, S, node_pad, V) in an
    evaluator call of ``lanes`` lanes over ``part`` (one partition's
    [Np, W] tables or a stacked [P, Np, W] bundle): what
    ``ResourceProfiler.attribute_kernel`` costs."""
    Np, W = part["ell_dst"].shape[-2:]
    return (int(lanes), min(cfg.expand_block, cfg.cap + Np), int(W), cfg.q_pad,
            cfg.s_pad, int(Np), int(owner.shape[0]))


def ranked_slots(cfg: EngineConfig, part: Dict[str, torch.Tensor], lanes: int,
                 loops: int) -> int:
    """Candidate slots the appends ranked in ``loops`` loops of an
    evaluator call of ``lanes`` lanes over ``part``: L x EB x W a loop."""
    Np, W = part["ell_dst"].shape[-2:]
    return int(loops) * int(lanes) * min(cfg.expand_block, cfg.cap + int(Np)) * int(W)


def stack_entry_part(part: Dict[str, Union[int, torch.Tensor]]
                     ) -> Dict[str, torch.Tensor]:
    """A single-partition evaluator dict as a stacked P=1 bundle (views;
    the scalars become [1] tensors on the tables' device)."""
    dev = part["node_label"].device
    return {k: (torch.tensor([int(v)], dtype=torch.int32, device=dev)
                if isinstance(v, int) else v.unsqueeze(0))
            for k, v in part.items()}


# ---------------------------------------------------------------------------
# Host-side helpers shared with the store and the OPAT orchestrator
# ---------------------------------------------------------------------------

def part_to_device_dict(p: PartitionArrays) -> Dict[str, np.ndarray]:
    """The evaluator's input dict for one partition, as host numpy arrays
    (the store pins and stages them)."""
    assert p.ell_dst is not None, "call PartitionArrays.to_ell() first"
    return dict(
        pid=np.int32(p.pid),
        n_core=np.int32(p.n_core),
        node_gid=p.node_gid,
        node_label=p.node_label,
        node_value=p.node_value,
        ell_dst=p.ell_dst,
        ell_label=p.ell_label,
        ell_dir=p.ell_dir,
        ell_dlab=p.ell_dlab,
        ell_dval=p.ell_dval,
        ell_dgid=p.ell_dgid,
    )


def plan_to_device(pa: PlanArrays, device: Optional[torch.device] = None) -> PlanArrays:
    """The same PlanArrays with every array field a tensor on ``device``
    (``n_slots`` / ``n_steps`` stay Python ints)."""
    dev = resolve_device(device)
    return dataclasses.replace(pa, **{
        f: torch.as_tensor(np.asarray(getattr(pa, f))).to(dev)
        for f in _PLAN_TENSOR_FIELDS})
