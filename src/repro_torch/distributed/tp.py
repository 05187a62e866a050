"""Dense tensor parallelism over a mesh's ``model`` axis: the layouts the
JAX package's GSPMD gives the resolver's specs (heads, kv_heads, mlp,
vocab, lru, experts; the S-sharded KV cache; ``tp_act``), written out as
collectives, for the train step (``fsdp.make_train_step``), prefill and
decode.

The block code (``models.transformer``, ``models.rglru``,
``models.xlstm``, ``serving.decode``) reads the axis through
``ModelAxis``: a leaf is cut when its model dim is this rank's block (the
block code compares its shape with the config's), and each collective
follows ``comm``'s Megatron convention.  A replicated input to a product
with cut columns goes through ``copy_to`` (its cotangent is summed over
the ranks), a product over a cut inner dim is partial and is summed
(``reduce_sum``), and a replicated leaf of which each rank uses only its
own part (kv heads replicated under cut q heads, sLSTM's gate bias, the
qk-norm scales under cut heads) goes through ``copy_to`` too.  So every
parameter's gradient comes out of the backward whole for its block, and
no leaf's gradient is summed over ``model`` afterwards: a leaf that every
rank used whole on replicated values (a norm scale) has the same gradient
on every rank.  Where the resolver could not divide a dim (reduced qwen2's
two kv heads on M = 4), that part runs whole on every rank.

  * Attention: this rank's q heads (``wq``, ``bq``, ``wo``'s rows); kv
    heads local where ``kv_heads`` is cut, all of them where it is
    replicated (each local q head reads kv head h // (H / Hkv)); ``wo``
    row-parallel.
  * FFN and shared experts: ``w_gate`` / ``w_up`` column-, ``w_down``
    row-parallel.  Routed experts: ``whole_batch_moe`` keeps the dense
    ``moe_ffn``'s semantics (the whole batch routed, as GSPMD routes it)
    by gathering the tokens over ``data`` and running ``moe_ffn_tp`` over
    ``model``.
  * Vocab: the input embedding looks up the rows a rank holds and sums
    over ``model``; the logits are [B_local, S, V/M] (float32) and
    ``train.step.cross_entropy`` takes its log-sum-exp over ``model``.
  * RG-LRU, mLSTM, sLSTM: see their modules.
  * ``tp_act``: the residual stream between blocks is this rank's block
    of d; a block all-gathers d at its entry and reduce-scatters its
    row-parallel output.
  * Prefill gives this rank's [B_local, V/M] last-position logits and the
    caches laid out per ``cache_shardings`` (k/v: batch over ``data``, S
    over ``model`` where M divides it; recurrent states: the width over
    ``model`` where it is >= 1024 and M divides it).  Decode writes the
    new token's k/v on the rank that holds its row, attends with all q
    heads over each rank's rows and combines the partial softmax over
    ``model`` (flash-decode); its MoE layers route the whole batch.  The
    block code holds a recurrent state as its weights are cut (this
    rank's lru width, mLSTM up width or sLSTM heads); the state is moved
    between that layout and the cache's only where the two differ.

On a model axis of 1 every program here is the one-process program, op
for op (``model_axis`` gives ``WHOLE``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import comm
from ..launch.sharding import batch_axes
from ..models.config import BLOCK_LOCAL_ATTN, BLOCK_MLSTM, BLOCK_RECURRENT, BLOCK_SLSTM
from ..models.layers import WHOLE, Whole


class ModelAxis(Whole):
    """This rank's place on the ``model`` axis: its group, the axis size
    M and this rank's index; ``act`` when the residual stream is d-cut
    (``tp_act``); ``seq_len`` the caches' full length in a decode step."""

    def __init__(self, group, size: int, rank: int, act: bool = False,
                 seq_len: Optional[int] = None):
        self.group, self.size, self.rank = group, size, rank
        self.act, self.seq_len = act, seq_len

    def cut(self, local: int, full: int) -> bool:
        if local != full and local * self.size != full:
            raise ValueError(f"a block of {local} is not 1/{self.size} of {full}")
        return local != full

    def cols(self, x):
        return comm.copy_to(x, self.group)

    def part(self, w):
        return comm.copy_to(w, self.group)

    def reduce(self, y):
        return comm.reduce_sum(y, self.group)

    def scatter(self, y, dim: int):
        return comm.reduce_scatter(y, dim, self.group)

    def split(self, y, dim: int):
        return comm.split(y, dim, self.group)

    def gather(self, t, dim: int):
        return comm.all_gather(t, dim, self.group, reduce=False)

    def max(self, t):
        return comm.all_max(t, self.group)

    def enter(self, x):
        return self.gather(x, -1) if self.act else x

    def exit(self, y):
        return self.scatter(y, -1) if self.act else self.reduce(y)

    def exit_whole(self, y):
        return self.split(y, -1) if self.act else y


def model_axis(mesh, cfg, *, tp_act: bool = False, seq_len: Optional[int] = None) -> Whole:
    """The block code's view of ``mesh``'s model axis: ``WHOLE`` when it is
    1 wide (or absent), else this rank's ``ModelAxis``.  ``tp_act`` cuts
    the residual stream's d where M divides it (the reference's
    ``act_constraint`` constrains only then)."""
    M = mesh.shape.get("model", 1)
    if M == 1:
        return WHOLE
    return ModelAxis(mesh.group("model"), M, mesh.index("model"),
                     act=tp_act and cfg.d_model % M == 0, seq_len=seq_len)


def block_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's ``model`` block of a tensor whole over ``model`` (a
    cache or logits of the local batch) under ``spec``."""
    from ..launch.sharding import spec_dim
    d = spec_dim(spec, "model")
    if d is None:
        return t
    n = t.shape[d] // mesh.shape["model"]
    return t.narrow(d, mesh.index("model") * n, n).contiguous()


def whole_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The inverse of ``block_of``: the tensor whole over ``model``."""
    from ..launch.sharding import spec_dim
    d = spec_dim(spec, "model")
    if d is None:
        return t
    with torch.no_grad():
        return comm.all_gather(t, d, mesh.group("model"), reduce=False)


def whole_batch_moe(cfg, mesh, batch: int) -> Optional[Callable]:
    """``forward``'s ``moe_fn`` keeping the dense ``moe_ffn``'s semantics
    on a mesh: route, sort, drop by capacity and take the aux loss over the
    WHOLE batch, as the one-process call does.  Each MoE layer gathers its
    tokens over the dp axes that cut the batch (``data``, or ``pod`` and
    ``data``: the one gather that crosses pods besides the gradient sums),
    runs ``moe_ffn_tp`` over ``model`` where the experts are cut
    (``moe_ffn`` where they are not) and keeps its own rows; the aux loss,
    the same on every dp rank, sends 1/n of its cotangent from each of the
    n.  None where no axis cuts anything (the dense call as it is)."""
    from ..models.layers import moe_ffn, moe_ffn_tp
    if not cfg.is_moe:
        return None
    axes, group, n = batch_axes(mesh, batch)
    rows = bool(axes)
    M = mesh.shape.get("model", 1)
    experts = M > 1 and cfg.n_experts % M == 0
    if not (rows or experts):
        return None
    model = mesh.group("model") if M > 1 else None
    r = mesh.index(axes)

    def moe_fn(p, x):
        b, S, d = x.shape
        xs = comm.all_gather(x, 0, group) if rows else x
        N = xs.shape[0]
        kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
        if p.e_gate.shape[0] != cfg.n_experts:
            y, aux = moe_ffn_tp(xs.reshape(N * S, d), p.router, p.e_gate, p.e_up, p.e_down,
                                group=model, **kw)
        else:
            y, aux = moe_ffn(xs.reshape(N * S, d), p.router, p.e_gate, p.e_up, p.e_down, **kw)
        y = y.reshape(N, S, d)
        if not rows:
            return y, aux
        return y[r * b:(r + 1) * b], comm.scale_grad(aux, 1.0 / n)
    return moe_fn


def logits_spec(mesh, batch: int, vocab: int) -> tuple:
    """[B, V] logits: batch over the dp axes, vocab over ``model`` where M
    divides it (``logit_constraint``'s layout without S)."""
    from ..launch.sharding import ShardingRules, _batch_dim_spec
    v = ShardingRules(mesh).resolve((vocab,), ("vocab",))
    return (_batch_dim_spec(mesh, batch), v[0] if v else None)


def whole_logits(logits: torch.Tensor, mesh, vocab: int) -> torch.Tensor:
    """This rank's [B_local, V/M] logits -> [B_local, V] (every model rank
    calls)."""
    return whole_of(logits, (None, "model") if logits.shape[-1] != vocab else (), mesh)


def _plan(model):
    from .fsdp import plan_of
    return plan_of(model)


def _view(model):
    from .fsdp import _Gathered
    return _Gathered(model, _plan(model), "", False)


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """A [B, S, ...] cache padded with zero positions to n."""
    if t.shape[1] == n:
        return t
    return torch.cat([t, t.new_zeros((t.shape[0], n - t.shape[1]) + t.shape[2:])], dim=1)


# A recurrent block's state follows the model cut of one of its weights:
# (that weight, the state's dim the cut falls on, the state's leaves).
_STATE_CUT = {BLOCK_RECURRENT: ("w_in", -1, ("h", "conv")),
              BLOCK_MLSTM: ("w_up", -1, ("conv",)),
              BLOCK_SLSTM: ("r_h", 1, ("c", "n", "m", "h"))}


def _state_dims(cfg, model, li: int) -> Dict[str, int]:
    """The state leaves of layer ``li`` that its block code holds as this
    rank's block, each with the dim it is cut along."""
    cut = _STATE_CUT.get(cfg.block_kind(li))
    if cut is None or _plan(model).mdims[f"layers.{li}.{cut[0]}"] is None:
        return {}
    return dict.fromkeys(cut[2], cut[1])


def _same_cut(t: torch.Tensor, dim: Optional[int], spec) -> bool:
    from ..launch.sharding import spec_dim
    d = spec_dim(spec, "model")
    return d is not None and dim is not None and dim % t.ndim == d


def _to_cache(t: torch.Tensor, dim: Optional[int], spec, mesh) -> torch.Tensor:
    """A state leaf in the block code's layout (this rank's block along
    ``dim``, or whole where ``dim`` is None) -> the cache's (``spec``)."""
    if _same_cut(t, dim, spec):
        return t
    if dim is not None:
        t = comm.all_gather(t, dim, mesh.group("model"), reduce=False)
    return block_of(t, spec, mesh)


def _to_block(t: torch.Tensor, dim: Optional[int], spec, mesh) -> torch.Tensor:
    """The inverse of ``_to_cache``."""
    if _same_cut(t, dim, spec):
        return t
    t = whole_of(t, spec, mesh)
    if dim is None:
        return t
    n = t.shape[dim] // mesh.shape["model"]
    return t.narrow(dim, mesh.index("model") * n, n)


def make_prefill(cfg, mesh, batch: int, s_max: int, *, tp_act: bool = False,
                 moe_fn=None, q_chunk: int = 512) -> Callable:
    """``prefill(model, local) -> (logits, caches)`` on ``mesh`` for global
    batches of ``batch`` rows: ``model`` went through
    ``fsdp.shard_model``, ``local`` is this rank's rows
    (``fsdp.local_batch``).  The logits are this rank's block of the last
    position's [B, V] (``logits_spec``); the caches are
    ``cache_shardings(cfg, mesh, batch, s_max)``'s blocks: the full
    attention's k/v padded to ``s_max`` positions, the local ring at
    min(window, s_max) slots (a prompt shorter than that fills slots
    0..S-1): the layout ``grow_caches`` gives the one-process caches
    grown to ``s_max``.  ``moe_fn`` (``layers.make_tp_moe_fn``) replaces
    the whole-batch MoE, as in the reference's prefill cell."""
    from ..launch.sharding import act_constraint, cache_shardings
    from ..serving.decode import prefill
    tp = model_axis(mesh, cfg, tp_act=tp_act)
    act = act_constraint(mesh, batch, tp_act=tp_act, d_model=cfg.d_model)
    if moe_fn is None:
        moe_fn = whole_batch_moe(cfg, mesh, batch)
    specs = cache_shardings(cfg, mesh, batch, s_max)
    W = min(cfg.local_window, s_max)

    def run(model, local: Dict[str, torch.Tensor]):
        with torch.no_grad():
            logits, caches = prefill(_view(model), cfg, local, q_chunk=q_chunk, act_shard=act,
                                     moe_fn=moe_fn, tp=tp)
            out = []
            for li, (c, sp) in enumerate(zip(caches, specs)):
                if "k" in c:
                    n = W if cfg.block_kind(li) == BLOCK_LOCAL_ATTN else s_max
                    out.append({k: block_of(_pad_rows(t, n), sp[k], mesh) for k, t in c.items()})
                else:
                    dims = _state_dims(cfg, model, li)
                    out.append({k: _to_cache(t, dims.get(k), sp[k], mesh).contiguous()
                                for k, t in c.items()})
        return logits, out
    return run


def make_decode_step(cfg, mesh, batch: int, s_max: int) -> Callable:
    """``decode_step(model, caches, local, pos) -> (logits, caches)`` on
    ``mesh``: ``caches`` are ``make_prefill``'s blocks (updated in place:
    the recurrent states are replaced by their new blocks), ``local``
    this rank's rows of the step's inputs.  The logits as
    ``make_prefill``'s."""
    from ..launch.sharding import cache_shardings
    from ..serving.decode import decode_step
    tp = model_axis(mesh, cfg, seq_len=s_max)
    moe_fn = whole_batch_moe(cfg, mesh, batch)
    specs = cache_shardings(cfg, mesh, batch, s_max)

    def run(model, caches: List[Dict[str, torch.Tensor]], local: Dict[str, torch.Tensor],
            pos: int):
        with torch.no_grad():
            dims = [_state_dims(cfg, model, li) for li in range(cfg.n_layers)]
            states = [{k: t if k in ("k", "v") else _to_block(t, d.get(k), sp[k], mesh)
                       for k, t in c.items()} for c, d, sp in zip(caches, dims, specs)]
            logits, states = decode_step(_view(model), cfg, states, local, pos, tp=tp,
                                         moe_fn=moe_fn)
            for c, st, d, sp in zip(caches, states, dims, specs):
                c.update({k: _to_cache(t, d.get(k), sp[k], mesh).contiguous()
                          for k, t in st.items() if k not in ("k", "v")})
        return logits, caches
    return run
