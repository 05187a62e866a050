"""AdamW with global-norm clipping and a cosine schedule: the JAX package's
``train/optimizer.py`` in plain tensor ops.

Not ``torch.optim.AdamW``: that applies the decay as ``p * (1 - lr * wd)``
before the step and has no global-norm clip and no schedule.  Here the
decay is added to the Adam direction (``delta + wd * p``) and the update
is ``(p.float() - lr * delta).to(p.dtype)``, as in the reference, so bf16
parameters are rounded every step (there are no float32 master weights).
The moments are float32.  The schedule and the bias corrections are
float32 tensors computed from an int32 step, as JAX computes them from a
weakly typed float and an int32 step.

The state is keyed by the model's parameter names
(``layers.3.ffn.w_gate``); the decay mask reads the last component, which
the port's ``Leaves`` keep equal to the reference's leaf key.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


OptState = Dict[str, object]     # {"step": int32 scalar, "m": {name: f32}, "v": {...}}


def _zeros_state(model: nn.Module, device) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device)
    named = list(model.named_parameters())
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "m": {n: zeros(p) for n, p in named},
        "v": {n: zeros(p) for n, p in named},
    }


def init_opt_state(model: nn.Module, *, device=None) -> OptState:
    """Zero moments for every parameter, on ``device``, which must be the
    model's.  ``device=None`` means the card, as for every entry point of
    the port (raises without one)."""
    from ..core.engine import resolve_device
    dev = resolve_device(device)
    where = {p.device.type for p in model.parameters()}
    if where != {dev.type}:
        raise ValueError(f"the model is on {sorted(where)}, not {dev.type}")
    return _zeros_state(model, dev)


def abstract_opt_state(model: nn.Module) -> OptState:
    """The same state on the ``meta`` device: shapes and dtypes only."""
    return _zeros_state(model, torch.device("meta"))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac * lr`` (float32)."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, each cast to float32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def _decay_mask(path_leaf_name: str) -> bool:
    """Weight decay applies to matrices, not norms/biases (by leaf name)."""
    nodecay = ("ln1", "ln2", "final_norm", "norm", "out_norm", "q_norm",
               "k_norm", "bq", "bk", "bv", "b", "lam", "b_i", "b_f")
    return path_leaf_name not in nodecay


def decays(name: str) -> bool:
    """The decay mask on a parameter name's last component."""
    return _decay_mask(name.rsplit(".", 1)[-1])


@torch.no_grad()
def adamw_update(cfg: OptConfig, model: nn.Module, grads: Dict[str, torch.Tensor],
                 opt_state: OptState, *,
                 gnorm: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """One AdamW step in place: the model's parameters, ``m``, ``v`` and
    ``step``.  ``grads`` maps every parameter name to its gradient.
    ``gnorm`` is the gradients' global norm where the caller has it (the
    whole model's, when ``grads`` are one rank's shards); by default
    ``global_norm`` of ``grads``.  Returns {"grad_norm", "lr"} (float32
    scalars)."""
    params = dict(model.named_parameters())
    if set(grads) != set(params):
        raise ValueError(f"gradients for {sorted(set(grads) ^ set(params))} "
                         "missing or unknown")
    if gnorm is None:
        gnorm = global_norm(grads[n] for n in params)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    opt_state["step"] += 1
    stepf = opt_state["step"].float()
    lr = schedule(cfg, opt_state["step"])
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    for name, p in params.items():
        m, v = opt_state["m"][name], opt_state["v"][name]
        g = grads[name].float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if decays(name):
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return {"grad_norm": gnorm, "lr": lr}

