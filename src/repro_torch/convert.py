"""Carry state built elsewhere (numpy arrays and label strings, e.g. from
the JAX package) into the port's host structures, so both packages can be
fed identical graphs, partitions and plans.

  graph_from_arrays              — a ``Graph`` from its arrays + vocab strings
  partitioned_graph_from_arrays  — a ``PartitionedGraph`` from a graph and
                                   a vertex assignment
  plan_arrays_from_numpy         — a ``PlanArrays`` from its fields
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .core.graph import Graph, LabelVocab, PartitionedGraph, build_partitions
from .core.plan import PlanArrays


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
