"""Graph data made from a seed, in NumPy, and the queries asked of it.

A generator is a module of this package, named by a configuration's
``generator``; it reads its sizes from the configuration.  It provides

  make(cfg, seed) -> GraphArrays       the whole graph
  TEMPLATES                            the query templates it can make
  make_query(g, cfg, template, rng)    one query as a plain JSON dict

A query dict has the form ``repro_torch.core.query.DisjunctiveQuery``
reads (``{"name", "disjuncts": [{"name", "nodes", "edges"}]}``); the
benchmark hands the same dict to the program and to the reference.

Every generator fixes the graph's shape (its edges between entities)
from the configuration's ``structure_seed`` and draws from the run's seed a
renumbering of the vertices and the labels and values that set no
degree above a hub's.  So every seed serves the same hubs, and with them
the same ELL width and device bytes, in another order.
"""
from __future__ import annotations

import dataclasses
import importlib
from types import ModuleType
from typing import List

import numpy as np


@dataclasses.dataclass
class GraphArrays:
    """One graph: vertex labels (ids into ``node_labels``) and float32
    values (NaN: none), and edges with labels (ids into ``edge_labels``)
    and a directed flag."""

    node_label: np.ndarray       # [V] int32
    node_value: np.ndarray       # [V] float32
    edge_src: np.ndarray         # [E] int32
    edge_dst: np.ndarray         # [E] int32
    edge_label: np.ndarray       # [E] int32
    edge_directed: np.ndarray    # [E] bool
    node_labels: List[str]
    edge_labels: List[str]

    @property
    def n_nodes(self) -> int:
        return int(self.node_label.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])

    def degree(self) -> np.ndarray:
        """Entries of each vertex in the symmetrized adjacency: every edge
        counts once at each end."""
        n = self.n_nodes
        return (np.bincount(self.edge_src, minlength=n)
                + np.bincount(self.edge_dst, minlength=n))

    def renumbered(self, perm: np.ndarray) -> "GraphArrays":
        """The same graph with vertex ``v`` renamed ``perm[v]``."""
        perm = np.asarray(perm, dtype=np.int64)
        label = np.empty_like(self.node_label)
        value = np.empty_like(self.node_value)
        label[perm] = self.node_label
        value[perm] = self.node_value
        return dataclasses.replace(
            self, node_label=label, node_value=value,
            edge_src=perm[self.edge_src].astype(np.int32),
            edge_dst=perm[self.edge_dst].astype(np.int32))


def generator(name: str) -> ModuleType:
    """The generator module ``graphbench.datasets.<name>``."""
    if not name.replace("_", "").isalnum():
        raise ValueError(f"bad generator name {name!r}")
    return importlib.import_module(f"{__name__}.{name}")


def node_spec(label: str = "?", value_op: str = "", value: float = 0.0) -> dict:
    return {"label": label, "value_op": value_op, "value": float(value)}


def edge_spec(a: int, b: int, label: str = "?", direction: int = 0) -> dict:
    return {"a": a, "b": b, "label": label, "direction": direction}


def pattern(name: str, nodes: List[dict], edges: List[dict]) -> dict:
    return {"name": name, "nodes": nodes, "edges": edges}


def query(name: str, *patterns: dict) -> dict:
    return {"name": name, "disjuncts": list(patterns)}
