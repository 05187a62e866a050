"""Carry state built elsewhere (numpy arrays and label strings, e.g. from
the JAX package) into the port's host structures, so both packages can be
fed identical graphs, partitions and plans.

  graph_from_arrays              — a ``Graph`` from its arrays + vocab strings
  partitioned_graph_from_arrays  — a ``PartitionedGraph`` from a graph and
                                   a vertex assignment
  plan_arrays_from_numpy         — a ``PlanArrays`` from its fields

and the language models' parameter and cache trees (nested dicts and
lists of numpy arrays, the JAX package's layout: ``head_layers``, the
``body`` stacked across periods, ``tail_layers``) into the port's model
and cache list, which hold the layers in layer order:

  lm_params_from_tree / lm_tree_from_params   — tree <-> ``Model``
  lm_opt_state_from_tree / lm_tree_from_opt_state
                                              — the optimizer state's
                                                ``{"step", "m", "v"}``
  lm_caches_from_tree / lm_tree_from_caches   — tree <-> cache list
  split_layers / join_layers                  — the layout alone
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .core.graph import Graph, LabelVocab, PartitionedGraph, build_partitions
from .core.plan import PlanArrays
from .models.config import ModelConfig
from .models.transformer import Model, stack_segments


def _vocab(labels: Sequence[str]) -> LabelVocab:
    v = LabelVocab()
    for s in labels:
        v.intern(str(s))
    assert len(v) == len(labels), "vocab strings must be unique"
    return v


def graph_from_arrays(*, node_label, node_value, edge_src, edge_dst,
                      edge_label, edge_directed,
                      node_vocab: Sequence[str],
                      edge_vocab: Sequence[str]) -> Graph:
    """``node_vocab[i]`` / ``edge_vocab[i]`` are the strings of label id i."""
    g = Graph(n_nodes=int(np.asarray(node_label).shape[0]),
              node_label=np.asarray(node_label, dtype=np.int32).copy(),
              node_value=np.asarray(node_value, dtype=np.float32).copy(),
              edge_src=np.asarray(edge_src, dtype=np.int32).copy(),
              edge_dst=np.asarray(edge_dst, dtype=np.int32).copy(),
              edge_label=np.asarray(edge_label, dtype=np.int32).copy(),
              edge_directed=np.asarray(edge_directed, dtype=bool).copy(),
              node_vocab=_vocab(node_vocab), edge_vocab=_vocab(edge_vocab))
    g.validate()
    return g


def partitioned_graph_from_arrays(graph: Graph, assignment, k: int,
                                  scheme: str = "?") -> PartitionedGraph:
    """Partitions of ``graph`` under a given [V] vertex assignment."""
    return build_partitions(graph, np.asarray(assignment).astype(np.int32), k,
                            scheme=scheme)


def plan_arrays_from_numpy(*, n_slots, n_steps, start_slot, start_label,
                           start_value_op, start_value, src_slot, dst_slot,
                           edge_label, direction, dst_label, dst_value_op,
                           dst_value, closes_cycle) -> PlanArrays:
    i32, f32 = np.int32, np.float32
    return PlanArrays(
        n_slots=int(n_slots), n_steps=int(n_steps),
        start_slot=i32(start_slot), start_label=i32(start_label),
        start_value_op=i32(start_value_op), start_value=f32(start_value),
        src_slot=np.asarray(src_slot, i32), dst_slot=np.asarray(dst_slot, i32),
        edge_label=np.asarray(edge_label, i32),
        direction=np.asarray(direction, i32),
        dst_label=np.asarray(dst_label, i32),
        dst_value_op=np.asarray(dst_value_op, i32),
        dst_value=np.asarray(dst_value, f32),
        closes_cycle=np.asarray(closes_cycle, i32))


# ---------------------------------------------------------------------------
# Language models: parameter and cache trees
# ---------------------------------------------------------------------------

_SEGMENTS = ("head_layers", "body", "tail_layers")


def _flatten(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[leaf] = v
    return out


def split_layers(cfg: ModelConfig, tree) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """(top-level leaves, one flat {dotted name: leaf} dict per layer in
    layer order): the ``body`` leaves [n_periods, ...] are unstacked into
    layers ``first_dense_layers + i * period + j``."""
    head, body, tail = stack_segments(cfg)
    layers: List[Dict[str, Any]] = [{} for _ in range(cfg.n_layers)]
    for seg, idx in (("head_layers", head), ("tail_layers", tail)):
        for i, li in enumerate(idx):
            layers[li] = _flatten(tree[seg][i])
    for j, stacked in enumerate(tree.get("body", [])):
        flat = _flatten(stacked)
        for t, period in enumerate(body):
            layers[period[j]] = {k: v[t] for k, v in flat.items()}
    top = {k: v for k, v in tree.items() if k not in _SEGMENTS}
    return top, layers


def join_layers(cfg: ModelConfig, top: Dict[str, Any], layers: List[Dict[str, Any]],
                stack: Callable = torch.stack):
    """The inverse of ``split_layers``: body layers stacked with ``stack``."""
    head, body, tail = stack_segments(cfg)
    tree = dict(top)
    if head:
        tree["head_layers"] = [_nest(layers[li]) for li in head]
    if body:
        tree["body"] = [_nest({k: stack([layers[period[j]][k] for period in body])
                               for k in layers[body[0][j]]})
                        for j in range(len(body[0]))]
    if tail:
        tree["tail_layers"] = [_nest(layers[li]) for li in tail]
    return tree


def dtype_name(dtype) -> str:
    """'float32', 'bfloat16', 'int32', ... for a numpy or a torch dtype."""
    return str(dtype).rsplit(".", 1)[-1]


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """A copy of ``a`` as a tensor of the same dtype.  numpy holds a JAX
    bf16 array as an ``ml_dtypes`` bfloat16 array, which ``torch.from_numpy``
    rejects: it goes through float32, which is exact.  A tensor is copied
    as it is."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device, copy=True)
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                         dtype=torch.bfloat16)
    return torch.from_numpy(a).to(device)


def _resolve(device):
    from .core.engine import resolve_device
    return resolve_device(device)


def lm_named_from_tree(cfg: ModelConfig, tree) -> Dict[str, Any]:
    """A parameter-shaped tree as {parameter name: leaf}."""
    top, layers = split_layers(cfg, tree)
    flat = dict(top)
    for i, layer in enumerate(layers):
        flat.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return flat


def lm_tree_from_named(cfg: ModelConfig, named: Dict[str, Any],
                       stack: Callable = torch.stack):
    """{parameter name: leaf} in the reference's tree layout; the body's
    leaves are stacked across periods with ``stack``."""
    top, layers = {}, [{} for _ in range(cfg.n_layers)]
    for name, t in named.items():
        if name.startswith("layers."):
            _, i, rest = name.split(".", 2)
            layers[int(i)][rest] = t
        else:
            top[name] = t
    return join_layers(cfg, top, layers, stack)


def _check_names(flat: Dict[str, Any], params: Dict[str, Any]) -> None:
    if set(flat) != set(params):
        raise ValueError(f"leaves differ: tree only {sorted(set(flat) - set(params))}, "
                         f"model only {sorted(set(params) - set(flat))}")


def lm_params_from_tree(cfg: ModelConfig, tree, *, device=None) -> Model:
    """The reference's parameter tree carried into the port's ``Model``:
    every leaf's name, shape and dtype must match.  ``device=None`` means
    the card (raises without one)."""
    dev = _resolve(device)
    flat = lm_named_from_tree(cfg, tree)
    model = Model(cfg, dev)
    params = dict(model.named_parameters())
    _check_names(flat, params)
    with torch.no_grad():
        for name, p in params.items():
            t = tensor_from_numpy(flat[name], dev)
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} in the tree, "
                                 f"{tuple(p.shape)} {p.dtype} in the model")
            p.copy_(t)
    return model


def lm_tree_from_params(cfg: ModelConfig, model: Model):
    """The model's parameters in the reference's tree layout (tensors)."""
    return lm_tree_from_named(cfg, {n: p.detach() for n, p in model.named_parameters()})


def lm_opt_state_from_tree(cfg: ModelConfig, tree, model: Model, *, device=None):
    """The reference's optimizer state ``{"step", "m", "v"}`` (``m`` and
    ``v`` in the parameter tree's layout) as the port's name-keyed state:
    every moment float32 and of its parameter's shape.  ``device=None``
    means the card (raises without one)."""
    dev = _resolve(device)
    params = dict(model.named_parameters())
    out = {"step": tensor_from_numpy(tree["step"], dev).to(torch.int32)}
    for key in ("m", "v"):
        flat = lm_named_from_tree(cfg, tree[key])
        _check_names(flat, params)
        out[key] = {}
        for name, p in params.items():
            t = tensor_from_numpy(flat[name], dev)
            if t.shape != p.shape or t.dtype != torch.float32:
                raise ValueError(f"{key} {name}: {tuple(t.shape)} {t.dtype}, want "
                                 f"{tuple(p.shape)} float32")
            out[key][name] = t
    return out


def lm_tree_from_opt_state(cfg: ModelConfig, opt_state):
    """The port's optimizer state in the reference's layout (tensors)."""
    return {"step": opt_state["step"],
            "m": lm_tree_from_named(cfg, opt_state["m"]),
            "v": lm_tree_from_named(cfg, opt_state["v"])}


def lm_caches_from_tree(cfg: ModelConfig, tree, *, device=None) -> List[Dict[str, torch.Tensor]]:
    """The reference's cache tree as the port's cache list (layer order)."""
    dev = _resolve(device)
    _, layers = split_layers(cfg, tree)
    return [{k: tensor_from_numpy(v, dev) for k, v in c.items()} for c in layers]


def lm_tree_from_caches(cfg: ModelConfig, caches: List[Dict[str, torch.Tensor]]):
    """The port's cache list in the reference's tree layout (tensors)."""
    return join_layers(cfg, {}, caches)
