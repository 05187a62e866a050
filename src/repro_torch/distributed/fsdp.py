"""FSDP over ``data`` with dense tensor parallelism over ``model`` on a
(D, M) mesh, or a (P, D, M) mesh with ``pod``: the JAX package's
``param_shardings`` / ``opt_shardings`` layout (its train CLI's
``make_test_mesh((jax.device_count(), 1))``, its ``build_cell`` train
program) over ``torch.distributed``.

Placement.  ``shard_model`` keeps, of every parameter, the block its
resolved spec gives this rank (the reference's ``addressable_shards``): a
leaf is cut along its ``embed`` dim where the ``data`` axis divides it and
along its heads / mlp / vocab / experts / lru dim where the ``model`` axis
divides it; any other dim stays whole on every rank.  ``shard_opt_state``
cuts ``m`` and ``v`` the same way; ``init_opt_state`` of a sharded model
gives the same zeros.  AdamW runs on the local blocks.  ``distributed.tp``
says how the blocks run over ``model``; this module handles ``data``.

The step.  The forward reads the model through a view whose every
parameter read all-gathers the leaf over ``data`` (``comm.all_gather``,
one layer's weights at a time; a checkpointed body period gathers again
in its recompute; the ``model`` block stays local) and whose backward
reduce-scatters the gradient back to the block.  This is FSDP written
out: an all-gather / reduce-scatter ``autograd.Function`` around each leaf
instead of ``fully_shard``, so that each reduction is the one the math
needs, on gloo and NCCL alike.

``jit`` with shardings never changes the reference's math, so the
sharded step computes what the one-process step computes; every
operation that mixes the batch is combined across ``data``:
  * the cross entropy and the z-loss divide by the WHOLE batch's unmasked
    count, so the ranks' losses sum to the batch's, and the ranks'
    gradients are summed (reduce-scatter; an all-reduce for the leaves the
    spec replicates);
  * the dense ``moe_ffn`` routes, sorts, drops by capacity and computes its
    aux loss over the whole batch: each MoE layer all-gathers its tokens
    over ``data``, runs on all of them, and keeps its own rows (the aux
    loss, replicated, sends 1/D of its cotangent from each rank;
    ``tp.whole_batch_moe``), unless ``make_train_step`` is given a
    ``moe_fn`` (``layers.make_tp_moe_fn``: capacity and aux per data
    shard, as in the reference's step with its ``moe_fn``);
  * the global gradient norm adds each leaf's block sums of squares across
    the axes that cut it, and each replicated leaf's once;
  * a batch that ``data`` does not divide is replicated
    (``_batch_dim_spec`` is None): every rank runs the whole batch, and no
    gradient is summed.
``pod`` is pure data parallelism: every leaf is replicated over it (the
resolver puts no parameter there), the batch is cut over pod x data
(``_batch_dim_spec``), and the mask count, the loss terms and every
gradient are summed over ``pod`` as well (the leaves ``data`` does not cut
over one "pod+data" group, the others, reduce-scattered over ``data``,
then all-reduced over ``pod``): besides the loss scalars the gradient
all-reduce is the only collective that crosses pods, as in the
reference.
Over ``model`` every operation is combined inside the forward and its
backward (``distributed.tp``), so the losses and the gradients of the
blocks are the same on every model rank.  A one-rank mesh replicates
every leaf (the resolver shards only over an axis wider than 1), so its
step is the one-process step's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

from ..convert import lm_named_from_tree, lm_tree_from_named
from ..launch.sharding import (NamedSharding, ShardingRules, Spec, _batch_dim_spec,
                               act_constraint, batch_axes, embed_overrides,
                               logit_constraint, named_specs, spec_axes, spec_dim)
from ..models.config import ModelConfig
from ..models.transformer import Model
from ..train.optimizer import OptState, adamw_update
from ..train.step import TrainConfig, grads_of, loss_fn
from . import comm
from .checkpoint import map_tree
from .tp import model_axis, whole_batch_moe


@dataclasses.dataclass
class MeshPlan:
    """Where a sharded model's leaves lie: each parameter's spec, the dim
    cut over ``data`` and the dim cut over ``model`` (None where the spec
    puts that axis nowhere)."""

    mesh: Any
    specs: Dict[str, Spec]
    dims: Dict[str, Optional[int]]
    mdims: Dict[str, Optional[int]]

    @property
    def group(self):
        return self.mesh.group("data")

    def sharding(self, name: str) -> NamedSharding:
        return NamedSharding(self.mesh, self.specs[name])


def _check_mesh(mesh) -> None:
    if "data" not in mesh.axis_names or "model" not in mesh.axis_names:
        raise ValueError(f"the mesh needs 'data' and 'model' axes: {mesh.axis_names}")
    wide = {a: n for a, n in mesh.shape.items()
            if a not in ("pod", "data", "model") and n > 1}
    if wide:
        raise NotImplementedError(f"mesh axes {wide}: the trainer runs on "
                                  "('pod', 'data', 'model') meshes")


def _cut(plan: MeshPlan, name: str) -> bool:
    return plan.dims[name] is not None or plan.mdims[name] is not None


def plan_of(model: nn.Module) -> MeshPlan:
    plan = getattr(model, "mesh_plan", None)
    if plan is None:
        raise ValueError("the model is not sharded: call shard_model first")
    return plan


def shard_model(model: Model, mesh, *, embed_vocab_shard: bool = True) -> Model:
    """Cut every parameter of ``model`` (whole leaves, the same on every
    rank) to this rank's block, in place; the model keeps its
    ``MeshPlan`` as ``model.mesh_plan``.  ``embed_vocab_shard=False``
    keeps the embedding table's vocab whole (``sharding.embed_overrides``;
    its d is still cut over ``data``)."""
    _check_mesh(mesh)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    specs = named_specs(shapes, ShardingRules(mesh), embed_overrides(embed_vocab_shard))
    plan = MeshPlan(mesh, specs, {n: spec_dim(s, "data") for n, s in specs.items()},
                    {n: spec_dim(s, "model") for n, s in specs.items()})
    with torch.no_grad():
        for n, p in model.named_parameters():
            if _cut(plan, n):
                p.data = plan.sharding(n).shard(p.data)
    model.mesh_plan = plan
    return model


def shard_opt_state(opt: OptState, model: Model, mesh) -> OptState:
    """Whole ``m`` and ``v`` cut like their (sharded) parameters (so with
    ``shard_model``'s ``embed_vocab_shard``)."""
    plan = plan_of(model)
    if plan.mesh is not mesh:
        raise ValueError("the model was sharded over another mesh")
    out = {"step": opt["step"]}
    for key in ("m", "v"):
        out[key] = {n: plan.sharding(n).shard(t) if _cut(plan, n) else t
                    for n, t in opt[key].items()}
    return out


def full_leaves(model: Model, leaves: Optional[Dict[str, torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
    """{name: the whole leaf} of name-keyed blocks laid out like the
    model's parameters (by default the parameters; or ``m``, ``v``),
    gathered over ``data`` and ``model``; every rank calls."""
    plan = plan_of(model)
    if leaves is None:
        leaves = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for n, t in leaves.items():
            t = t.detach()
            for dim, axis in ((plan.dims[n], "data"), (plan.mdims[n], "model")):
                if dim is not None:
                    t = comm.all_gather(t, dim, plan.mesh.group(axis))
            out[n] = t
    return out


def checkpoint_state(cfg: ModelConfig, model: Model, opt: OptState) -> Dict[str, Any]:
    """The train state in the reference's checkpoint layout (``{"params":
    tree, "opt": {"step", "m", "v"}}``), each leaf a DTensor of this rank's
    block: ``save_checkpoint`` gathers it whole.  Also the template for
    ``load_checkpoint``."""
    plan = plan_of(model)
    rules = ShardingRules(plan.mesh)
    local = {"params": lm_tree_from_named(cfg, {n: p.detach() for n, p in
                                                model.named_parameters()}),
             "opt": {"step": opt["step"], "m": lm_tree_from_named(cfg, opt["m"]),
                     "v": lm_tree_from_named(cfg, opt["v"])}}
    return map_tree(local, state_shardings(cfg, model), lambda t, s: DTensor.from_local(
        t, plan.mesh.device_mesh, rules.placements(s.spec), run_check=False))


def state_shardings(cfg: ModelConfig, model: Model) -> Dict[str, Any]:
    """``checkpoint_state``'s layout with each leaf's ``NamedSharding``, for
    ``load_checkpoint(shardings=)``: a body leaf stacked across periods
    gets a leading None."""
    plan = plan_of(model)
    named = {n: plan.sharding(n) for n in plan.specs}
    stack = lambda xs: NamedSharding(plan.mesh, (None,) + xs[0].spec)
    tree = lambda: lm_tree_from_named(cfg, named, stack)
    return {"params": tree(),
            "opt": {"step": NamedSharding(plan.mesh, ()), "m": tree(), "v": tree()}}


@torch.no_grad()
def load_state(cfg: ModelConfig, model: Model, opt: OptState, state: Dict[str, Any]) -> None:
    """Copy a restored state (this rank's blocks, ``state_shardings``'
    layout) into the model and the optimizer state in place."""
    def copy(dst: torch.Tensor, src: torch.Tensor, what: str) -> None:
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{what}: {tuple(src.shape)} restored, {tuple(dst.shape)} held")
        dst.copy_(src)

    named = lm_named_from_tree(cfg, state["params"])
    for n, p in model.named_parameters():
        copy(p, named[n], n)
    copy(opt["step"], state["opt"]["step"], "step")
    for key in ("m", "v"):
        named = lm_named_from_tree(cfg, state["opt"][key])
        for n, t in opt[key].items():
            copy(t, named[n], f"{key} {n}")


def local_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors): each
    [B, ...] leaf cut over the dp axes ``_batch_dim_spec`` gives B, whole
    where it gives None."""
    out = {}
    for k, v in batch.items():
        if not len(v.shape):
            out[k] = v
            continue
        axes = spec_axes(_batch_dim_spec(mesh, v.shape[0]))
        rows = v.shape[0] // math.prod(mesh.shape[a] for a in axes)
        idx = mesh.index(axes)
        out[k] = v[idx * rows:(idx + 1) * rows]
    return out


class _Gathered:
    """A sharded module seen whole over ``data``: a parameter read
    all-gathers its leaf over ``data`` (a leaf ``data`` does not cut is read
    as it is; the ``model`` block stays this rank's); submodules are viewed
    alike."""

    __slots__ = ("_module", "_plan", "_prefix", "_reduce")

    def __init__(self, module: nn.Module, plan: MeshPlan, prefix: str, reduce: bool):
        self._module, self._plan, self._prefix, self._reduce = module, plan, prefix, reduce

    def __getattr__(self, name: str):
        v = getattr(self._module, name)
        full = self._prefix + name
        if isinstance(v, nn.Parameter):
            dim = self._plan.dims[full]
            return v if dim is None else comm.all_gather(v, dim, self._plan.group, self._reduce)
        if isinstance(v, nn.ModuleList):
            return [_Gathered(m, self._plan, f"{full}.{i}.", self._reduce)
                    for i, m in enumerate(v)]
        if isinstance(v, nn.Module):
            return _Gathered(v, self._plan, full + ".", self._reduce)
        return v


def global_norm(grads: Dict[str, torch.Tensor], plan: MeshPlan) -> torch.Tensor:
    """The whole model's gradient norm from this rank's blocks: a leaf's
    sum of squares is added across each axis that cuts it, a replicated
    leaf's counted once (``optimizer.global_norm``'s order)."""
    sq = {n: torch.sum(torch.square(g.float())) for n, g in grads.items()}
    for axis, dims in (("data", plan.dims), ("model", plan.mdims)):
        cut = [n for n in sq if dims[n] is not None]
        if cut:
            v = torch.stack([sq[n] for n in cut])
            dist.all_reduce(v, op=dist.ReduceOp.SUM, group=plan.mesh.group(axis))
            sq.update(zip(cut, v.unbind()))
    return torch.sqrt(sum(sq.values()))


def make_value_and_grad(cfg: ModelConfig, tcfg: TrainConfig, mesh, batch: int,
                        moe_fn=None) -> Callable:
    """``value_and_grad(model, local) -> (total, {"nll", "aux"}, grads)`` on
    ``mesh`` for global batches of ``batch`` rows: the whole batch's loss
    terms (the same on every rank) and the gradient of each of this rank's
    blocks (``train.step.value_and_grad`` of the one-process model, cut).
    ``moe_fn`` replaces the whole-batch MoE (``make_train_step``)."""
    _check_mesh(mesh)
    act = act_constraint(mesh, batch, tp_act=tcfg.tp_act, d_model=cfg.d_model)
    logit = logit_constraint(mesh, batch, cfg.vocab)
    tp = model_axis(mesh, cfg, tp_act=tcfg.tp_act)
    routed = moe_fn if moe_fn is not None else whole_batch_moe(cfg, mesh, batch)
    rows, group, n_rows = batch_axes(mesh, batch)
    pod = mesh.group("pod") if "pod" in rows else None

    def value_and_grad(model: Model, local: Dict[str, torch.Tensor]):
        plan = plan_of(model)
        if plan.mesh is not mesh:
            raise ValueError("the model was sharded over another mesh")
        mask = local.get("loss_mask")
        count = (mask.float().sum() if mask is not None else
                 torch.tensor(float(local["labels"].numel()), device=local["labels"].device))
        if rows:
            dist.all_reduce(count, op=dist.ReduceOp.SUM, group=group)
        view = _Gathered(model, plan, "", "data" in rows)
        total, parts, grads = grads_of(
            dict(model.named_parameters()),
            lambda: loss_fn(view, cfg, local, tcfg, act, logit, routed, count=count, tp=tp))
        if rows:
            for n, g in grads.items():
                if plan.dims[n] is None:
                    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
                elif pod is not None:       # reduce-scattered over data already
                    dist.all_reduce(g, op=dist.ReduceOp.SUM, group=pod)
            # the ranks' shares sum to the batch's loss; the replicated aux
            # term is in each share once
            ln = torch.stack([total, parts["nll"]])
            dist.all_reduce(ln, op=dist.ReduceOp.SUM, group=group)
            aux_term = tcfg.aux_loss_weight * parts["aux"]
            total, parts["nll"] = ln[0] - (n_rows - 1) * aux_term, ln[1]
        return total, parts, grads
    return value_and_grad


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh, batch: int,
                    moe_fn=None) -> Callable:
    """``train_step(model, opt_state, local) -> metrics`` on a (D, M) or
    (P, D, M) mesh for global batches of ``batch`` rows: ``model`` went through
    ``shard_model``, ``opt_state`` is its blocks' state, and ``local`` is
    this rank's rows (``local_batch``).  The metrics are the whole batch's,
    the same on every rank.  ``moe_fn`` (``layers.make_tp_moe_fn``)
    replaces the dense MoE's whole-batch routing."""
    grad_fn = make_value_and_grad(cfg, tcfg, mesh, batch, moe_fn)

    def train_step(model: Model, opt_state: OptState,
                   local: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        total, parts, grads = grad_fn(model, local)
        opt_metrics = adamw_update(tcfg.opt, model, grads, opt_state,
                                   gnorm=global_norm(grads, plan_of(model)))
        return {"loss": total, **parts, **opt_metrics}
    return train_step
