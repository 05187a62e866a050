"""Divisibility-aware sharding rule resolver: the JAX package's
``launch/sharding.py`` with each leaf's spec as plain data.

Parameter leaf NAMES carry sharding meaning: ``AXES_BY_NAME`` maps each leaf
name to per-dim logical axes, and ``LOGICAL_TO_MESH`` maps logical axes to
candidate mesh axes.  The resolver assigns a mesh axis to a dim only when
the axis size divides the dim and the axis is not already used in that spec
— so e.g. qwen2-1.5b's 12 heads silently fall back to replication over the
16-wide model axis while its ff/vocab dims still shard, and GQA kv-heads
smaller than the model axis are stored replicated.

A spec is the reference's ``PartitionSpec`` as a tuple: one entry per
leading dim, each a mesh axis name, a tuple of names (several dp axes on
one dim) or None.  The resolver reads only ``mesh.axis_names`` and
``mesh.shape`` (a dict), so a stand-in mesh resolves without devices.

The reference stacks the body's parameters and caches as
``[n_periods, ...]`` and gives them a leading None; the port keeps one
module per layer, so a body leaf's spec here is the reference's without
that leading None.  Specs are keyed by the port's parameter names
(``Model.named_parameters()``, ``convert.lm_named_from_tree``) and caches
by layer (``serving.decode``'s list of dicts).

``act_constraint`` and ``logit_constraint`` return closures that check a
tensor is this rank's block and hand it back: the reference's
``with_sharding_constraint`` asks XLA for a layout, and the port's
programs (``distributed.fsdp``, ``distributed.tp``) compute in that
layout, so the closure checks it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import Replicate, Shard

from ..models.config import ModelConfig
from ..models.transformer import abstract_params
from ..serving.decode import abstract_caches
from .mesh import dp_axes

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]

# leaf name -> logical axis per (trailing) dim
AXES_BY_NAME: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "lm_head": ("embed", "vocab"),
    "in_proj": (None, "embed"),
    "img_proj_w1": (None, "embed"),
    "img_proj_w2": (None, "embed"),
    # attention
    "wq": ("embed", "heads", None),
    "wk": ("embed", "kv_heads", None),
    "wv": ("embed", "kv_heads", None),
    "wo": ("heads", None, "embed"),
    "bq": ("heads", None),
    "bk": ("kv_heads", None),
    "bv": ("kv_heads", None),
    # dense FFN (also mLSTM up/gate/down: same shapes/meaning)
    "w_gate": ("embed", "mlp"),
    "w_up": ("embed", "mlp"),
    "w_down": ("mlp", "embed"),
    # MoE
    "router": ("embed", None),
    "e_gate": ("experts", "embed", None),
    "e_up": ("experts", "embed", None),
    "e_down": ("experts", None, "embed"),
    "s_gate": ("embed", "mlp"),
    "s_up": ("embed", "mlp"),
    "s_down": ("mlp", "embed"),
    # RG-LRU
    "w_in": ("embed", "lru"),
    "w_gate_branch": ("embed", "lru"),
    "conv_w": (None, "lru"),
    "w_rgate": ("lru", None),
    "w_igate": ("lru", None),
    "lam": ("lru",),
    "w_out": ("lru", "embed"),
    # mLSTM extras
    "w_q": ("mlp", None),
    "w_k": ("mlp", None),
    "w_v": ("mlp", None),
    "w_i": ("mlp", None),
    "w_f": ("mlp", None),
    "b_i": (None,),
    "b_f": (None,),
    "out_norm": (None,),
    # sLSTM
    "w_x": ("embed", "mlp"),
    "r_h": ("heads", None, None),
    "b": (None,),
    # norms
    "ln1": (None,), "ln2": (None,), "final_norm": (None,),
    "norm": (None,), "q_norm": (None,), "k_norm": (None,),
    # optimizer scalars
    "step": (),
}

LOGICAL_TO_MESH: Dict[str, Tuple[str, ...]] = {
    "embed": ("data",),           # FSDP
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "experts": ("model",),
    "lru": ("model",),
}


def leaf_name(name: str) -> str:
    """The last component of a parameter name (``layers.3.ffn.w_gate``)."""
    return name.rsplit(".", 1)[-1]


def _strip(spec: List[Entry]) -> Spec:
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def spec_axes(entry: Entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim a spec puts on ``axis`` (None where it puts it nowhere)."""
    dims = [d for d, e in enumerate(spec) if axis in spec_axes(e)]
    return dims[0] if dims else None


@dataclasses.dataclass
class ShardingRules:
    mesh: object
    logical_to_mesh: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(LOGICAL_TO_MESH))

    def resolve(self, shape: Sequence[int],
                logical: Sequence[Optional[str]]) -> Spec:
        """Assign mesh axes to dims by divisibility; never reuse an axis."""
        logical = tuple(logical)
        if len(logical) < len(shape):                 # leading dims replicated
            logical = (None,) * (len(shape) - len(logical)) + logical
        used = set()
        spec: List[Entry] = []
        for dim, name in zip(shape, logical):
            assigned = None
            if name is not None:
                for ax in self.logical_to_mesh.get(name, ()):
                    if ax in self.mesh.axis_names and ax not in used \
                            and dim % self.mesh.shape[ax] == 0 \
                            and self.mesh.shape[ax] > 1:
                        assigned = ax
                        used.add(ax)
                        break
            spec.append(assigned)
        return _strip(spec)

    def placements(self, spec: Spec) -> list:
        """DTensor placements per mesh dim: ``Shard(d)`` where the spec puts
        that axis on dim d, ``Replicate()`` where it uses the axis nowhere."""
        out = []
        for ax in self.mesh.axis_names:
            dims = [d for d, e in enumerate(spec) if ax in spec_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def named(self, spec: Spec) -> "NamedSharding":
        return NamedSharding(self.mesh, tuple(spec))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``launch.mesh.Mesh``): how one leaf lies across
    the ranks.  ``shard`` cuts this rank's block out of the whole leaf."""

    mesh: object
    spec: Spec

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, in a storage of its own (a view
        of a dim-0 block would keep the whole leaf's storage alive)."""
        t = full
        for d, entry in enumerate(self.spec):
            for ax in spec_axes(entry):
                n = self.mesh.shape[ax]
                t = t.chunk(n, dim=d)[self.mesh.index(ax)]
        return t.contiguous() if t is full else t.clone(memory_format=torch.contiguous_format)


def named_specs(shapes: Dict[str, Sequence[int]], rules: ShardingRules,
                overrides=None) -> Dict[str, Spec]:
    """{name: spec} for named leaf shapes, by each name's last component."""
    out = {}
    for name, shape in shapes.items():
        leaf = leaf_name(name)
        logical = (overrides or {}).get(leaf, AXES_BY_NAME.get(leaf))
        if logical is None:
            logical = (None,) * len(shape)
        out[name] = rules.resolve(tuple(shape), logical)
    return out


def embed_overrides(embed_vocab_shard: bool):
    """embed_vocab_shard=False stores the embedding table vocab-REPLICATED
    (d still FSDP-sharded): the token gather becomes local after one cheap
    weight all-gather instead of forcing a full-activation all-reduce of the
    masked partial gather."""
    if embed_vocab_shard:
        return {}
    return {"embed": (None, "embed")}


def _param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    return {n: tuple(p.shape) for n, p in abstract_params(cfg).named_parameters()}


def param_shardings(cfg: ModelConfig, mesh, *,
                    embed_vocab_shard: bool = True) -> Dict[str, Spec]:
    """{parameter name: spec}."""
    return named_specs(_param_shapes(cfg), ShardingRules(mesh),
                       embed_overrides(embed_vocab_shard))


def opt_shardings(cfg: ModelConfig, mesh, *,
                  embed_vocab_shard: bool = True):
    """The optimizer state's specs: ``{"step": (), "m": {...}, "v": {...}}``
    (each moment has its parameter's spec)."""
    rules = ShardingRules(mesh)
    params = param_shardings(cfg, mesh, embed_vocab_shard=embed_vocab_shard)
    return {"step": rules.resolve((), AXES_BY_NAME["step"]),
            "m": dict(params), "v": dict(params)}


def _batch_dim_spec(mesh, b: int) -> Entry:
    """Shard the batch dim over as many dp axes as divide it."""
    axes = []
    rem = b
    for a in dp_axes(mesh):
        sz = mesh.shape[a]
        if sz > 1 and rem % sz == 0:
            axes.append(a)
            rem //= sz
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def batch_shardings(mesh, batch_tree: Dict[str, Sequence[int]]) -> Dict[str, Spec]:
    """Inputs {name: shape}: [B, ...] -> batch over dp axes, rest replicated."""
    out = {}
    for name, shape in batch_tree.items():
        shape = tuple(shape)
        if not shape:
            out[name] = ()
        else:
            out[name] = (_batch_dim_spec(mesh, shape[0]),) + (None,) * (len(shape) - 1)
    return out


def cache_shardings(cfg: ModelConfig, mesh, batch: int, s_max: int,
                    *, shard_cache_seq: bool = True) -> List[Dict[str, Spec]]:
    """KV caches: [B, S, Hkv, hd] -> (dp on B, model on S) — S-sharded
    flash-decode layout.  Recurrent states: dp on B, model on the state
    width when large and divisible.  One dict per layer."""
    out = []
    for layer in abstract_caches(cfg, batch, s_max):
        specs = {}
        for name, leaf in layer.items():
            shape = tuple(leaf.shape)
            nd = len(shape)
            if name in ("k", "v") and nd >= 4:
                sspec = None
                if shard_cache_seq and "model" in mesh.axis_names \
                        and shape[-3] % mesh.shape["model"] == 0:
                    sspec = "model"
                specs[name] = (_batch_dim_spec(mesh, shape[-4]), sspec, None, None)
                continue
            spec: List[Entry] = [None] * nd
            if nd:
                spec[0] = _batch_dim_spec(mesh, shape[0])
            if nd >= 2 and shape[-1] >= 1024 and "model" in mesh.axis_names \
                    and shape[-1] % mesh.shape["model"] == 0:
                spec[-1] = "model"
            specs[name] = _strip(spec)
        out.append(specs)
    return out


def batch_axes(mesh, batch: int) -> tuple:
    """The dp axes a global batch of ``batch`` rows is cut over (none
    where it is replicated), their group (None where none) and the number
    of ranks they span."""
    axes = spec_axes(_batch_dim_spec(mesh, batch))
    return axes, (mesh.group(axes) if axes else None), math.prod(mesh.shape[a] for a in axes)


def local_batch_size(mesh, batch: int) -> int:
    """The rows of a [batch, ...] input that one rank holds."""
    n = 1
    for ax in spec_axes(_batch_dim_spec(mesh, batch)):
        n *= mesh.shape[ax]
    return batch // n


def _last_dim(mesh, n: Optional[int], cut: bool) -> Optional[int]:
    """This rank's share of a last dim of ``n`` entries: n / M where
    ``cut`` and the model axis M divides n, else n (None: not checked)."""
    M = mesh.shape.get("model", 1)
    if n is None or not cut or n % M:
        return n
    return n // M


def _block_check(mesh, batch: int, last: Optional[int], what: str):
    rows = local_batch_size(mesh, batch)

    def constrain(x):
        if x.ndim == 3 and (x.shape[0] != rows
                            or (last is not None and x.shape[-1] != last)):
            raise ValueError(f"{what}: {tuple(x.shape)} is not this rank's block "
                             f"[{rows} of {batch} rows, S, {last}]")
        return x
    return constrain


def logit_constraint(mesh, batch: int, vocab: int):
    """The [B, S, V] logits' closure: batch over dp, vocab over ``model``
    where M divides it; it checks x is this rank's [B_local, S, V/M] block
    (V where the vocab is whole)."""
    return _block_check(mesh, batch, _last_dim(mesh, vocab, True), "logits")


def act_constraint(mesh, batch: int, *, tp_act: bool = False,
                   d_model: Optional[int] = None):
    """The [B, S, d] block activations' closure: batch over dp, d
    replicated, or with ``tp_act`` over ``model`` where M divides it.  It
    checks x is this rank's [B_local, S, d] block ([B_local, S, d/M] under
    ``tp_act``); the last dim only when ``d_model`` is given (the
    reference's closure takes no width)."""
    return _block_check(mesh, batch, _last_dim(mesh, d_model, tp_act), "activations")
