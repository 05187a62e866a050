"""Static cost counter over the ATen ops a PyTorch call runs: the port's
counterpart of the JAX package's ``launch/hlo_cost.py``.

The reference parses a call's HLO and multiplies ``while`` bodies by their
trip counts.  The port has no HLO: ``OpCostMode`` is a
``TorchDispatchMode`` that sees every ATen op the call runs, the backward
and ``torch.utils.checkpoint``'s recompute included.  Run it on ``meta``
tensors (``abstract_params``, ``abstract_opt_state``, ``abstract_caches``)
and it counts a call of any size without allocating or computing anything.
The streams keep the reference's meanings, on one device:

flops      ``mm``, ``bmm``, ``addmm``, ``baddbmm`` (where ``einsum`` and
           ``matmul`` land), ``mv`` and ``dot`` count 2*M*N*K; a
           convolution 2*numel(result)*numel(kernel), as the reference
           counts it; elementwise ops numel(result); reductions, scans and
           sorts numel(operand).  Copies, casts, views and factories count
           nothing.  ``flops_by_class`` splits them: ``dot_bf16`` for bf16
           and fp16 products (the tensor cores), ``dot_f32`` for float32
           products (the port computes attention tiles in float32, as the
           reference does, outside the tensor cores with TF32 off), and
           ``other`` for the rest, integer and bool work included.

bytes      the perfect-fusion floor.  Storages that reach the call as
           arguments (parameters, optimizer state, caches, the batch) are
           off-chip: each op that reads one, or a view of one, is charged
           the bytes it reads (a gather, ``index_select`` or ``embedding``
           the rows it returns).  An in-place write into an argument by
           ``copy_``, ``index_copy_``, ``index_put_``, ``index_add_`` or
           ``scatter_`` is charged the update only; an argument changed by
           any other in-place op (AdamW's ``m.mul_``) is charged once, as an
           output.  The call's outputs are charged once.  Every other
           intermediate is free: a perfectly fused kernel keeps it on chip.

bytes_xla_convention  operands plus results of every op that is not a
           view: a pessimistic upper band, as in the reference.

collectives  the ``c10d`` ops of ``torch.distributed`` (``distributed.comm``'s
           all-gathers, reduce-scatters and all-reduces), per kind with the
           reference's ring accounting: an all-gather is charged its
           result, an all-reduce twice its operand, a reduce-scatter or an
           all-to-all its operand.  Each is also charged operand plus result
           in the byte floor (the reference's ``hlo_cost``), counted in
           ``collective_op_executions``, and keyed by the mesh axes its group
           spans in ``collective_bytes_by_axis`` (``groups``: the mesh's
           ``axis_labels``).  A collective is never memoised, and one of
           another kind raises.  On one card there are none: the five keys
           are 0.

Memory: ``argument_bytes`` (the argument storages), ``output_bytes`` (the
returned storages and the arguments changed in place) and
``temp_peak_bytes``, the peak of storages made during the call and alive
at once (autograd's saved tensors keep theirs alive; a checkpointed
segment frees them).

Most of the time goes to the meta kernels themselves, so a functional op
on meta operands whose layouts it has seen before (every step of a
sequential scan repeats the same ops) gets fresh empty outputs of the
remembered layout instead of running again; the counts are those of a
run on real tensors (tested).

The layer stack is a Python loop, so a production shape at full depth
issues hundreds of thousands of ops.  ``analyze_stack`` counts the call at
the head + one body period + tail and again with two periods, and
extrapolates every stream linearly in the number of periods.  The periods
are identical, so this is exact for the op-by-op sums (flops, bytes, op
counts, collectives, argument and output sizes).  ``temp_peak_bytes`` is a maximum over
the call, not a sum: the live bytes at each point are affine in the number
of periods, so the peak is their maximum, convex in it, and the line through
one and two periods is a lower bound at more, exact where the same point
holds the peak at every depth.  A stack of at most three periods costs no
more counted whole, and is.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
FLOP_CLASSES = ("dot_bf16", "dot_f32", "other")

# collectives: c10d op -> (kind, the index of its operand argument, of its
# result argument); an all-reduce works in place, its operand is its result
_C10D = {"allreduce_": ("all-reduce", 0, 0),
         "allreduce_coalesced_": ("all-reduce", 0, 0),
         "_allgather_base_": ("all-gather", 1, 0),
         "allgather_into_tensor_coalesced_": ("all-gather", 1, 0),
         "_reduce_scatter_base_": ("reduce-scatter", 1, 0),
         "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1, 0),
         "alltoall_base_": ("all-to-all", 1, 0)}
# products: the index of the lhs operand (K is its last dim)
_DOTS = {aten.mm.default: 0, aten.bmm.default: 0, aten.mv.default: 0,
         aten.dot.default: 0, aten.addmm.default: 1, aten.baddbmm.default: 1}
_CONVS = {aten.convolution.default}
# in-place writes into operand 0 charged the update only: the index of
# the operand that holds it (``copy_``'s is its destination slice; a
# scattered scalar is charged per index)
_UPDATES = {aten.copy_.default: 0, aten.index_copy_.default: 3,
            aten.index_put_.default: 2, aten._index_put_impl_.default: 2,
            aten.index_add_.default: 3, aten.scatter_.src: 3,
            aten.scatter_.value: None}
# ops that read the rows of operand 0 they return
_GATHERS = {aten.index.Tensor, aten.index_select.default, aten.gather.default,
            aten.embedding.default}
# reductions, scans and sorts: numel(operand)
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
               "cumsum", "cumprod", "cummax", "cummin", "sort", "argsort", "argmax",
               "argmin", "any", "all", "var", "var_mean", "std", "norm",
               "linalg_vector_norm", "_softmax", "_log_softmax",
               "_softmax_backward_data", "_log_softmax_backward_data", "topk"}
# elementwise ops ATen does not tag pointwise
_POINTWISE = {"rsub", "log_sigmoid_forward", "log_sigmoid_backward"}
# copies and casts: bytes, no flops (the reference's convert and copy)
_COPIES = {"clone", "_to_copy", "copy_", "copy", "lift_fresh_copy"}
# ops that return a view of an input under another name
_ALIASES = {"_unsafe_view", "_reshape_alias", "view", "lift_fresh"}

_OTHER, _VIEW, _DOT, _CONV, _POINT, _REDUCE, _UPDATE, _GATHER = range(8)


def _classify(func) -> int:
    name = func.overloadpacket.__name__
    if func.is_view or name in _ALIASES:
        return _VIEW
    if func in _DOTS:
        return _DOT
    if func in _CONVS:
        return _CONV
    if func in _UPDATES:
        return _UPDATE
    if func in _GATHERS:
        return _GATHER
    if name in _COPIES:
        return _OTHER
    if name in _REDUCTIONS:
        return _REDUCE
    if torch.Tag.pointwise in func.tags or name in _POINTWISE:
        return _POINT
    return _OTHER


def _tensors(xs):
    for a in xs:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            for b in a:
                if isinstance(b, torch.Tensor):
                    yield b


def leaves(obj) -> List[torch.Tensor]:
    """Every tensor in ``obj``: a module's parameters and buffers, and the
    tensors inside dicts, lists and tuples."""
    out: List[torch.Tensor] = []
    stack = [obj]
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, torch.nn.Module):
            out.extend(o.parameters())
            out.extend(o.buffers())
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
    return out


def _layout(xs) -> tuple:
    """A hashable description of operands: each tensor's shape, stride and
    dtype, every other value with its type (``2``, ``2.0`` and ``True`` are
    equal keys but give other result dtypes; TypeError if unhashable)."""
    out = []
    for a in xs:
        if isinstance(a, torch.Tensor):
            out.append((a.shape, a.stride(), a.dtype))
        elif isinstance(a, (list, tuple)):
            out.append(_layout(a))
        else:
            hash(a)
            out.append((type(a), a))
    return tuple(out)


def _sid(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a read of ``t`` moves: its elements, at most its storage (an
    expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _numel_bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors((x,)))


def _class(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "dot_bf16"
    if dtype.is_floating_point:
        return "dot_f32"
    return "other"


@dataclasses.dataclass
class Counts:
    """One call's streams (the keys of ``as_dict``)."""
    flops_by_class: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(FLOP_CLASSES, 0))
    bytes: int = 0
    bytes_xla_convention: int = 0
    aten_ops: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_peak_bytes: int = 0
    collective_bytes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    # the axes a group spans ("data", "pod+data") -> kind -> bytes
    collective_bytes_by_axis: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    collective_ops: Dict[str, int] = dataclasses.field(      # executions per kind
        default_factory=lambda: dict.fromkeys(COLLECTIVES, 0))
    # (op, operand shapes) -> off-chip bytes charged
    contributors: Dict[Tuple[str, str], int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))

    @property
    def flops(self) -> int:
        return sum(self.flops_by_class.values())

    @property
    def collective_op_executions(self) -> int:
        return sum(self.collective_ops.values())

    def as_dict(self) -> Dict[str, object]:
        return {
            "flops": self.flops,
            "flops_by_class": dict(self.flops_by_class),
            "bytes": self.bytes,
            "bytes_xla_convention": self.bytes_xla_convention,
            "collective_bytes": {k: float(v) for k, v in self.collective_bytes.items()},
            "collective_bytes_total": float(sum(self.collective_bytes.values())),
            "collective_op_executions": self.collective_op_executions,
            "collective_ops": dict(self.collective_ops),
            "collective_bytes_by_axis": {a: {k: float(v) for k, v in kinds.items()}
                                         for a, kinds in self.collective_bytes_by_axis.items()},
            "aten_ops": self.aten_ops,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_peak_bytes": self.temp_peak_bytes,
        }

    def top_contributors(self, k: int = 20) -> List[Tuple[int, str, str]]:
        """The ``k`` (op, operand shapes) pairs charged the most off-chip
        bytes: (bytes, op, shapes), largest first."""
        rows = [(b, op, shapes) for (op, shapes), b in self.contributors.items()]
        return sorted(rows, reverse=True)[:k]


class OpCostMode(TorchDispatchMode):
    """Counts every ATen op and collective run under it into
    ``self.counts``.  ``args`` are the call's arguments (their storages are
    off-chip); ``groups`` names the process groups' axes ({group name:
    label}, ``launch.mesh.Mesh.axis_labels``; a group not in it is keyed
    by its name).  Call ``finish(result)`` after the call to charge its
    outputs."""

    def __init__(self, args=(), groups: Optional[Dict[str, str]] = None):
        super().__init__()
        self.counts = Counts()
        self._groups = dict(groups or {})
        # held for the whole call: a call may drop an argument from its
        # container (decode replaces the recurrent states), and a freed
        # storage's id can be reused by a temporary
        self._held = leaves(args)
        self._args: Dict[int, int] = {}
        for t in self._held:
            self._args[_sid(t)] = t.untyped_storage().nbytes()
        self.counts.argument_bytes = sum(self._args.values())
        self._written: Dict[int, int] = {}      # arguments changed in place
        self._live: Dict[int, int] = {}          # storages made by the call
        self._live_bytes = 0
        self._kinds: Dict[object, Tuple[int, bool]] = {}   # op -> (kind, mutable)
        # (op, operand shapes) -> its outputs' (shape, stride, dtype), or
        # None where they alias an operand (see _run)
        self._memo: Dict[tuple, object] = {}

    # -- temporaries ---------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        sid = st._cdata
        if sid in self._args or sid in self._live:
            return
        n = st.nbytes()
        self._live[sid] = n
        self._live_bytes += n
        if self._live_bytes > self.counts.temp_peak_bytes:
            self.counts.temp_peak_bytes = self._live_bytes
        weakref.finalize(st, self._free, sid)

    def _free(self, sid: int) -> None:
        self._live_bytes -= self._live.pop(sid, 0)

    def _offchip(self, t: torch.Tensor) -> bool:
        return _sid(t) in self._args

    def _run(self, func, args, kwargs, sids):
        """``func`` on meta operands (storages ``sids``), its outputs
        remembered by operand layouts: a functional op's outputs depend on
        nothing else, so a repeat (every step of a sequential scan) gets
        fresh empty tensors of the same layout without running the op's
        meta kernel again."""
        try:
            key = (func, _layout(args), _layout(kwargs.values()))
            memo = self._memo.get(key, False)
        except TypeError:           # an unhashable operand: run it
            return func(*args, **kwargs)
        if memo:
            outs = tuple(torch.empty_strided(shape, stride, dtype=dt, device="meta")
                         for shape, stride, dt in memo[1])
            return outs[0] if memo[0] else outs
        out = func(*args, **kwargs)
        if memo is False:
            single = isinstance(out, torch.Tensor)
            outs = (out,) if single else out
            if (isinstance(outs, (tuple, list)) and outs
                    and all(isinstance(t, torch.Tensor) and t.is_meta for t in outs)
                    and not any(_sid(t) in sids for t in outs)):
                self._memo[key] = (single, [(t.shape, t.stride(), t.dtype) for t in outs])
            else:
                self._memo[key] = None
        return out

    def _collective(self, func, args, kwargs):
        """A c10d collective: run (never memoised: it writes its result
        buffer), charged by its kind's ring rule and keyed by its group."""
        name = func.overloadpacket.__name__
        if name not in _C10D:
            raise NotImplementedError(f"OpCostMode counts no collective {func}")
        out = func(*args, **kwargs)
        kind, i_op, i_res = _C10D[name]
        opn, res = _numel_bytes(args[i_op]), _numel_bytes(args[i_res])
        wire = res if kind == "all-gather" else 2 * opn if kind == "all-reduce" else opn
        pg = next(dist.ProcessGroup.unbox(v) for a, v in zip(func._schema.arguments, args)
                  if "ProcessGroup" in str(a.type))
        label = self._groups.get(pg.group_name, pg.group_name)
        c = self.counts
        c.collective_bytes[kind] += wire
        c.collective_bytes_by_axis.setdefault(label, dict.fromkeys(COLLECTIVES, 0))[kind] += wire
        c.collective_ops[kind] += 1
        c.bytes += opn + res
        c.bytes_xla_convention += opn + res
        key = (name, " ".join(str(list(t.shape)) for t in _tensors(args)))
        c.contributors[key] += opn + res
        return out

    # -- per op ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            return self._collective(func, args, kwargs)
        spec = self._kinds.get(func)
        if spec is None:
            spec = self._kinds[func] = (_classify(func), func._schema.is_mutable)
        kind, mutable = spec
        if kind == _VIEW:
            return func(*args, **kwargs)
        ins = [*_tensors(args), *_tensors(kwargs.values())]
        sids = [_sid(t) for t in ins]
        if mutable or not all(t.is_meta for t in ins):
            out = func(*args, **kwargs)
        else:
            out = self._run(func, args, kwargs, set(sids))
        c = self.counts
        c.aten_ops += 1
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else (out,)))
        first = outs[0] if outs else None

        # flops
        if kind == _DOT:
            lhs = args[_DOTS[func]]
            c.flops_by_class[_class(first.dtype)] += 2 * first.numel() * lhs.shape[-1]
        elif kind == _CONV:
            c.flops_by_class[_class(first.dtype)] += 2 * first.numel() * args[1].numel()
        elif kind == _POINT and first is not None:
            c.flops_by_class["other"] += first.numel()
        elif kind == _REDUCE and ins:
            c.flops_by_class["other"] += ins[0].numel()

        # bytes, XLA convention
        c.bytes_xla_convention += (sum(t.numel() * t.element_size() for t in ins)
                                   + sum(t.numel() * t.element_size() for t in outs))

        # bytes, perfect-fusion floor
        charged = 0
        if kind == _UPDATE and self._offchip(args[0]):
            if func is aten.scatter_.value:     # a scalar at each index
                charged = args[2].numel() * args[0].element_size()
            else:
                charged = _nbytes(args[_UPDATES[func]])
        elif kind == _GATHER:
            if self._offchip(args[0]):
                charged = _nbytes(first)
            charged += sum(_nbytes(t) for t in _tensors(args[1:]) if self._offchip(t))
        else:
            charged = sum(_nbytes(t) for t, sid in zip(ins, sids) if sid in self._args)
        if kind != _UPDATE and mutable:
            for a, v in zip(func._schema.arguments, args):
                if (isinstance(v, torch.Tensor) and a.alias_info is not None
                        and a.alias_info.is_write and self._offchip(v)):
                    sid = _sid(v)
                    self._written[sid] = self._args[sid]
        if charged:
            c.bytes += charged
            key = (str(func.overloadpacket.__name__),
                   " ".join(str(list(t.shape)) for t in ins))
            c.contributors[key] += charged

        for t in outs:
            self._track(t)
        return out

    def finish(self, result) -> Counts:
        """Charge the call's outputs once: the returned storages that are
        not arguments, and the arguments changed by an in-place op other
        than an update (AdamW's moments)."""
        c = self.counts
        seen = set()
        for t in leaves(result):
            sid = _sid(t)
            if sid in seen:
                continue
            seen.add(sid)
            n = t.untyped_storage().nbytes()
            c.output_bytes += n
            if sid not in self._args:
                c.bytes += n
        for sid, n in self._written.items():
            c.bytes += n
            if sid not in seen:
                c.output_bytes += n
        return c


def count_call(fn: Callable, *args, groups: Optional[Dict[str, str]] = None,
               **kwargs) -> Counts:
    """Run ``fn(*args, **kwargs)`` under ``OpCostMode`` (``groups`` as
    there); its counts."""
    mode = OpCostMode((args, kwargs), groups)
    with mode:
        out = fn(*args, **kwargs)
    return mode.finish(out)


def analyze_call(fn: Callable, *args, **kwargs) -> Dict[str, object]:
    """The counterpart of ``analyze_hlo_text``: the reference's keys plus
    ``flops_by_class``, ``aten_ops`` and the memory sizes."""
    return count_call(fn, *args, **kwargs).as_dict()


def top_contributors(fn: Callable, *args, k: int = 20, **kwargs):
    """The counterpart of the reference's ``top_contributors``."""
    return count_call(fn, *args, **kwargs).top_contributors(k)


def _extrapolate(a: int, b: int, n: int) -> int:
    return a + (n - 1) * (b - a)


def analyze_stack(cfg, make_call: Callable, groups: Optional[Dict[str, str]] = None
                  ) -> Tuple[Counts, Dict[str, int]]:
    """Count a call of the model ``cfg`` at full depth from two shallow
    counts.  ``make_call(cfg)`` returns ``(fn, args, kwargs)`` for a config
    of that depth.  With ``stack_segments`` = (head, body periods, tail)
    and n periods: c1 counts head + 1 period + tail, c2 head + 2 periods +
    tail, and every stream is c1 + (n - 1) * (c2 - c1); ``temp_peak_bytes``
    so is a lower bound (module docstring).  Returns (the counts,
    {"periods": n, "layers_counted": layers of c1 + c2, "temp_peak_exact":
    False}).  At most three periods are counted whole ("temp_peak_exact":
    True).  ``groups`` as in ``OpCostMode``."""
    from ..models.transformer import stack_segments
    head, body, tail = stack_segments(cfg)
    n = len(body)
    if n <= 3:
        fn, args, kwargs = make_call(cfg)
        return count_call(fn, *args, groups=groups, **kwargs), {
            "periods": n, "layers_counted": cfg.n_layers, "temp_peak_exact": True}
    period = len(body[0])
    cuts = [dataclasses.replace(cfg, n_layers=len(head) + k * period + len(tail))
            for k in (1, 2)]
    c1, c2 = [count_call(fn, *args, groups=groups, **kwargs)
              for fn, args, kwargs in map(make_call, cuts)]
    out = Counts()
    for f in ("bytes", "bytes_xla_convention", "aten_ops", "argument_bytes",
              "output_bytes", "temp_peak_bytes"):
        setattr(out, f, _extrapolate(getattr(c1, f), getattr(c2, f), n))
    for k in FLOP_CLASSES:
        out.flops_by_class[k] = _extrapolate(c1.flops_by_class[k],
                                             c2.flops_by_class[k], n)
    for k in COLLECTIVES:
        out.collective_bytes[k] = _extrapolate(c1.collective_bytes[k],
                                               c2.collective_bytes[k], n)
        out.collective_ops[k] = _extrapolate(c1.collective_ops[k], c2.collective_ops[k], n)
    zero = dict.fromkeys(COLLECTIVES, 0)
    for a in set(c1.collective_bytes_by_axis) | set(c2.collective_bytes_by_axis):
        k1, k2 = (c.collective_bytes_by_axis.get(a, zero) for c in (c1, c2))
        out.collective_bytes_by_axis[a] = {k: _extrapolate(k1[k], k2[k], n)
                                           for k in COLLECTIVES}
    for key in set(c1.contributors) | set(c2.contributors):
        v = _extrapolate(c1.contributors.get(key, 0), c2.contributors.get(key, 0), n)
        if v:
            out.contributors[key] = v
    return out, {"periods": n, "layers_counted": sum(c.n_layers for c in cuts),
                 "temp_peak_exact": False}
