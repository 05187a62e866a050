"""The system under test, driven from outside: the port's ``Graph`` built
from the benchmark's arrays, a ``GraphSession`` with every partition on
the device, and the windows served through the SLO front end
(``repro_torch.serving.frontend.ServingFrontend``) with one class, "all",
of infinite deadline and ``shed_policy="never"``.

The front end is built once, in set-up (``Frontend``), and serves the
warm-up and every call of the window.  Each request's completion is
stamped on the host's clock by the cost model the front end is given
(``Clocked``), which hands every call on to the program's own
``CostModel``: the front end prices each request once, in arrival order,
and reports each completion to it as it drains the round that finished
it.
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch


def port_graph(g):
    """The port's ``Graph`` from the benchmark's arrays, through its
    public dataclass and label vocabulary."""
    from repro_torch.core.graph import Graph, LabelVocab
    nv, ev = LabelVocab(), LabelVocab()
    for s in g.node_labels:
        nv.intern(s)
    for s in g.edge_labels:
        ev.intern(s)
    graph = Graph(n_nodes=g.n_nodes, node_label=g.node_label.astype(np.int32),
                  node_value=g.node_value.astype(np.float32),
                  edge_src=g.edge_src.astype(np.int32),
                  edge_dst=g.edge_dst.astype(np.int32),
                  edge_label=g.edge_label.astype(np.int32),
                  edge_directed=g.edge_directed.astype(bool),
                  node_vocab=nv, edge_vocab=ev)
    graph.validate()
    return graph


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_session(cfg: dict, graph, device: torch.device, tracer=None,
                  times: Optional[Dict[str, float]] = None):
    """Partition, build the partitions' tables, open the session and put
    every partition on the device, as ``GraphSession(graph, ...)`` does,
    timing each stage into ``times``."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.graph import build_partitions
    from repro_torch.core.partition import partition_graph
    from repro_torch.core.session import GraphSession
    from repro_torch.obs.profile import NULL_PROFILER
    times = {} if times is None else times
    k, scheme, seed = int(cfg["k"]), cfg["scheme"], int(cfg["session_seed"])
    t = time.perf_counter()
    assign = partition_graph(graph, k, scheme, seed=seed)
    times["partition_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pg = build_partitions(graph, assign, k, scheme=scheme)
    times["tables_s"] = time.perf_counter() - t
    t = time.perf_counter()
    session = GraphSession(pg=pg, engine=cfg["engine"], heuristic=cfg["heuristic"],
                           config=EngineConfig(**cfg["engine_config"]),
                           cache_parts=cfg.get("cache_parts"),
                           prefetch=bool(cfg.get("prefetch", True)), seed=seed,
                           tracer=tracer, device=device, profiler=NULL_PROFILER)
    for pid in range(k):
        session.store.get(pid)
    sync(device)
    times["to_device_s"] = time.perf_counter() - t
    return session


class Clocked:
    """A cost model for the front end: the program's ``CostModel``, with
    the host time of each completion stamped per request."""

    def __init__(self, inner):
        self.inner = inner
        self.priced: List[object] = []
        self.done: Dict[int, float] = {}

    def predict_plans(self, plans, max_answers=None):
        est = self.inner.predict_plans(plans, max_answers)
        self.priced.append(est)
        return est

    def observe(self, est, latency_s):
        self.done.setdefault(id(est), time.perf_counter())
        return self.inner.observe(est, latency_s)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def completions(self, start: int, n: int) -> List[Optional[float]]:
        """Completion times of the n requests priced from ``start`` on, in
        pricing (arrival) order; None where a request was never priced
        or never completed."""
        out: List[Optional[float]] = [None] * n
        for i, est in enumerate(self.priced[start:start + n]):
            out[i] = self.done.get(id(est))
        return out


class Served:
    """What one window served: per request its due time, completion
    time (host perf_counter seconds) and answer rows."""

    def __init__(self):
        self.requests: List[dict] = []
        self.due: List[float] = []
        self.finished: List[Optional[float]] = []
        self.answers: List[Optional[np.ndarray]] = []
        self.t0 = self.t1 = 0.0
        self.loads = 0
        self.calls: List[float] = []     # seconds of each front-end call

    def latencies(self) -> List[float]:
        return [f - d for d, f in zip(self.due, self.finished) if f is not None]

    @property
    def completed(self) -> int:
        return sum(f is not None for f in self.finished)


class Frontend:
    """One ``ServingFrontend`` over the session, built once in set-up (its
    cost model walks every partition) and serving every call after."""

    def __init__(self, session, cfg: dict, speed: float):
        from repro_torch.serving.cost import CostModel
        from repro_torch.serving.frontend import SLOClass
        self.session = session
        self.speed = float(speed)
        self.clock = Clocked(CostModel(session.pg))
        self.fe = session.frontend(
            slo_classes=[SLOClass("all", deadline_s=math.inf, priority=0)],
            shed_policy="never", replay_speed=self.speed, cost_model=self.clock,
            heuristic=cfg["shared_heuristic"])

    def serve(self, reqs: List[dict], out: Served) -> None:
        """Serve ``reqs`` and add them to ``out``, in arrival order; due
        times count from the call (all at once under replay speed 0)."""
        from repro_torch.core.query import DisjunctiveQuery
        from repro_torch.serving.frontend import Request
        order = sorted(range(len(reqs)), key=lambda i: (reqs[i]["arrival_s"], i))
        reqs = [reqs[i] for i in order]
        port = [Request(query=DisjunctiveQuery.from_json_dict(r["query"]), slo_class="all",
                        arrival_s=r["arrival_s"], max_answers=r["max_answers"])
                for r in reqs]
        n0 = len(self.clock.priced)
        t0 = time.perf_counter()
        # the traced run names the front end's own host time in the trace
        with self.session.tracer.span("graphbench.serve", requests=len(port)):
            report = self.fe.serve(port)
        out.calls.append(time.perf_counter() - t0)
        done = self.clock.completions(n0, len(reqs))
        outs = report.outcomes if len(report.outcomes) == len(reqs) else [None] * len(reqs)
        for r, o, f in zip(reqs, outs, done):
            out.requests.append(r)
            out.due.append(t0 + (r["arrival_s"] / self.speed if self.speed > 0 else 0.0))
            ok = o is not None and o.status == "ok" and o.result is not None
            out.finished.append(f if ok else None)
            out.answers.append(np.asarray(o.result.answers) if ok else None)


def window(front: Frontend, traffic: dict, make_batch, reqs: Optional[List[dict]],
           seconds: float) -> Served:
    """The measured window: the open-loop requests ``reqs``, or batches
    from ``make_batch()`` until ``seconds`` have passed."""
    session = front.session
    out = Served()
    stats0 = session.store.stats.copy()
    out.t0 = time.perf_counter()
    if traffic["arrivals"] == "batch":
        while True:
            front.serve(make_batch(), out)
            if time.perf_counter() - out.t0 >= seconds:
                break
    else:
        front.serve(reqs, out)
    sync(session.device)
    out.t1 = time.perf_counter()
    delta = session.store.stats - stats0
    out.loads = int(delta.hits + delta.misses)
    return out
