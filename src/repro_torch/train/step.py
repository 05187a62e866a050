"""Loss and train-step builders: the JAX package's ``train/step.py`` in
PyTorch.

``make_train_step`` returns ``train_step(model, opt_state, batch) ->
metrics``: the loss, its backward, and ``adamw_update`` applied to the
model and the optimizer state in place (the port's counterpart of the
reference's ``donate_argnums=(0, 1)``).  The MoE aux loss and the z-loss
are folded in as the reference folds them.  ``act_shard``, ``logit_shard``
and ``moe_fn`` are ``forward``'s mesh hooks; the step on a (data, model)
mesh is ``distributed.fsdp.make_train_step``, which shares ``loss_fn``
(with ``tp``, the model axis, under which the logits are a vocab block
and ``cross_entropy`` is vocab-parallel).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..models.config import ModelConfig
from ..models.layers import WHOLE
from ..models.transformer import Model, forward
from .optimizer import OptConfig, OptState, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    aux_loss_weight: float = 0.01     # MoE load-balancing
    z_loss_weight: float = 1e-4       # logit normalizer regularizer
    remat: bool = True
    q_chunk: int = 512
    kv_chunk: int = 512
    causal_skip: bool = False
    tp_act: bool = False     # shard [B,S,d] activations over model too (on a
                             # mesh: distributed.tp)
    attn_remat: bool = False # recompute attention tiles in backward
    flash_cv: bool = False   # flash_attention_cv's hand-written backward


def _vocab_parallel(logits: torch.Tensor, labels: torch.Tensor, tp):
    """(log-sum-exp, gold logit) of logits that are this rank's block of
    the vocab over ``tp``: the max and the sum of exponents are combined
    over the ranks (the max carries no gradient: the log-sum-exp's does
    not depend on it), and the gold logit comes from the one rank that
    holds the label (the others add 0)."""
    n = logits.shape[-1]
    m = tp.max(logits.amax(dim=-1))
    lse = m + torch.log(tp.reduce(torch.exp(logits - m[..., None]).sum(dim=-1)))
    t = labels.long() - tp.offset(n * tp.size)
    mine = (t >= 0) & (t < n)
    gold = torch.gather(logits, -1, torch.where(mine, t, 0)[..., None])[..., 0]
    return lse, tp.reduce(torch.where(mine, gold, 0.0))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss_weight: float = 0.0, *,
                  count: Optional[torch.Tensor] = None,
                  tp=WHOLE) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B,S,V] f32, labels [B,S] int.  Mean NLL over unmasked
    positions, plus z-loss.  Returns (total, nll).  ``count`` is the number
    of unmasked positions the means divide by (``mask.sum()`` by default;
    the whole batch's when the logits are one data shard of it, so that the
    shards' losses sum to the batch's).  Under a ``tp`` of more than one
    rank the logits are this rank's block of the vocab (rank r holds
    [r V/M, (r+1) V/M)), and the result is the same on every rank."""
    if tp.size == 1:
        lse = torch.logsumexp(logits, dim=-1)                            # [B,S]
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]  # [B,S]
    else:
        lse, gold = _vocab_parallel(logits, labels, tp)
    nll = lse - gold
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.float()
    denom = torch.clamp_min(mask.sum() if count is None else count, 1.0)
    loss = (nll * mask).sum() / denom
    zl = ((lse * lse) * mask).sum() / denom
    return loss + z_loss_weight * zl, loss


def loss_fn(model: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            tcfg: TrainConfig, act_shard=None, logit_shard=None, moe_fn=None, *,
            count: Optional[torch.Tensor] = None, tp=WHOLE
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, {"nll", "aux"}); ``count`` as in ``cross_entropy``,
    ``tp`` as in ``forward``."""
    logits, aux = forward(model, cfg, batch, remat=tcfg.remat,
                          q_chunk=tcfg.q_chunk, kv_chunk=tcfg.kv_chunk,
                          causal_skip=tcfg.causal_skip, act_shard=act_shard,
                          logit_shard=logit_shard, moe_fn=moe_fn,
                          attn_remat=tcfg.attn_remat, flash_cv=tcfg.flash_cv, tp=tp)
    vocab_tp = tp if tp.cut(logits.shape[-1], cfg.vocab) else WHOLE
    total, nll = cross_entropy(logits, batch["labels"], batch.get("loss_mask"),
                               tcfg.z_loss_weight, count=count, tp=vocab_tp)
    total = total + tcfg.aux_loss_weight * aux
    return total, {"nll": nll, "aux": aux}


def grads_of(params: Dict[str, torch.nn.Parameter], loss: Callable):
    """``loss()`` -> (total, parts) run with ``params`` requiring grad, and
    its backward: (total, parts, {name: gradient}), detached."""
    for p in params.values():
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            total, parts = loss()
            total.backward()
        grads = {}
        for name, p in params.items():
            grads[name] = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = None
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return total.detach(), {k: v.detach() for k, v in parts.items()}, grads


def value_and_grad(model: Model, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                   tcfg: TrainConfig, act_shard=None, logit_shard=None, moe_fn=None):
    """(total, {"nll", "aux"}, {name: gradient}): the loss and its backward.
    The parameters require grad only for the call."""
    return grads_of(dict(model.named_parameters()),
                    lambda: loss_fn(model, cfg, batch, tcfg, act_shard, logit_shard, moe_fn))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, act_shard=None,
                    logit_shard=None, moe_fn=None) -> Callable:
    def train_step(model: Model, opt_state: OptState,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        total, parts, grads = value_and_grad(model, cfg, batch, tcfg, act_shard,
                                             logit_shard, moe_fn)
        opt_metrics = adamw_update(tcfg.opt, model, grads, opt_state)
        return {"loss": total, **parts, **opt_metrics}
    return train_step
