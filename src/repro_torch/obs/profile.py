"""Resource profiling: memory accounting, kernel cost attribution, and SLO
burn-rate monitoring on top of the span tracing (obs/trace.py).

Three read-only instruments:

  memory accounting   ``ResourceProfiler.sample_device`` stamps the
                      store's live device bytes (the sum of its cache
                      entries' ``nbytes``) onto a closing span
                      (``store.load``/``store.prefetch``/``kernel.eval``)
                      and tracks the session-level peak; ``observe_rss``
                      samples the process peak RSS from ``getrusage``.
                      Byte *flows* (cold/prefetch/disk/host-cache traffic)
                      are already counted by ``LoadStats``; the profiler
                      adds the *stock*, what is resident right now.
  cost attribution    ``attribute_kernel`` costs one launch of the
                      hand-written frontier step (csrc/fused_frontier.cu)
                      from its shapes alone (``kernels.ops.step_cost``: an
                      upper bound at full occupancy), once per kernel key,
                      and folds it through a roofline of one H100: a
                      memory term at HBM bandwidth and a compute term at
                      the card's INT32 rate (the step does integer work).
                      There is no collective term: the cost is the step's,
                      and MapReduceMP's shuffle between shards is not
                      costed.  ``stamp_kernel`` writes the
                      call's cost -- one launch's times the call's step
                      launches -- onto every ``kernel.eval`` span, so a
                      trace joins *predicted* cost with *measured* wall
                      time (``tools/trace_report.py --cost``).
  SLO burn rate       ``SloBurnMonitor`` keeps a rolling window of
                      deadline outcomes per SLO class; burn rate is the
                      window's miss fraction over the error budget.

What a span's cost covers: the evaluator is a Python loop with one step
launch per iteration, so the cost is the step kernel's alone.  The JAX
package costed its whole jitted evaluator; here the roofline share is the
step's bound against the whole call's wall time (the loop's other device
work and its host time included).

``sample_device``, ``observe_rss``, ``snapshot``, ``SloBurnMonitor`` and
``resource_profile_snapshot`` are copies of the JAX package's
``obs/profile.py``, logic unchanged, so ``peak_device_bytes`` means the
same in both packages: the store's live entry bytes, not the allocator's
peak (``torch.cuda.max_memory_allocated``, which also holds the work
buffers).

Discipline is identical to ``trace.NULL_TRACER``: every hot-path call
site holds a profiler reference that is ``NULL_PROFILER`` when profiling
is off, so the disabled path costs about a method call and profiling on
or off leaves every answer unchanged.  A failure inside attribution
degrades to zeroed costs with ``cost_error``; profiling never breaks
serving.
"""
from __future__ import annotations

import collections
import resource
from typing import Any, Deque, Dict, Optional, Sequence

# Roofline peaks of one NVIDIA H100 80GB HBM3 (SXM), read as
# "NVIDIA H100 80GB HBM3, 700.00 W" by nvidia-smi on the card this port is
# measured on.  HBM: NVIDIA's H100 data sheet (SXM part).
H100_HBM_BYTES_PER_S = 3.35e12
# SMs: torch.cuda.get_device_properties(0).multi_processor_count; clock:
# nvidia-smi --query-gpu=clocks.max.sm (MHz), both on that card.
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1980e6
# 32-bit integer add, compare, logic and shift results per clock per SM on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table).
INT32_OPS_PER_SM_CLOCK = 64
H100_INT32_OPS_PER_S = H100_SMS * INT32_OPS_PER_SM_CLOCK * H100_MAX_SM_CLOCK_HZ


def _key_str(key: Any) -> str:
    """Canonical string form of a kernel key (tuples stay readable:
    ('opat', 'eval') -> 'opat:eval', ('scheduler.tmp', 8) -> 'scheduler.tmp:8')."""
    if isinstance(key, tuple):
        return ":".join(str(k) for k in key)
    return str(key)


def step_roofline(ops: float, nbytes: float) -> Dict[str, Any]:
    """Fold (operations, bytes) through the H100 roofline: the bound is
    the larger of bytes over HBM bandwidth and operations over the INT32
    rate, and ``dominant`` names the larger term."""
    t_mem = nbytes / H100_HBM_BYTES_PER_S
    t_ops = ops / H100_INT32_OPS_PER_S
    return {"flops": float(ops), "bytes": float(nbytes),
            "t_bound_us": max(t_mem, t_ops) * 1e6,
            "dominant": "memory" if t_mem >= t_ops else "compute"}


class NullResourceProfiler:
    """The disabled path: every method is a no-op, shared as the module
    singleton ``NULL_PROFILER`` so call sites never branch."""

    __slots__ = ()
    enabled = False

    def sample_device(self, span: Any, store: Any) -> None:
        pass

    def observe_rss(self) -> int:
        return 0

    def attribute_kernel(self, key: Any, *shape: Any, lanes: Any = None) -> None:
        pass

    def stamp_kernel(self, span: Any, key: Any, launches: int) -> None:
        pass

    def snapshot(self) -> Dict[str, Any]:
        return {"enabled": False}


NULL_PROFILER = NullResourceProfiler()


class ResourceProfiler:
    """Collects resource facts for one session; owned by ``GraphSession``
    (built whenever a real ``Tracer`` is attached) and threaded to the
    store, the engines and the scheduler the way the tracer is."""

    enabled = True

    def __init__(self, tracer: Optional[Any] = None):
        self.tracer = tracer
        self.peak_device_bytes = 0
        self.peak_rss_bytes = 0
        # kernel key -> predicted cost of ONE step launch (once per key)
        self.kernel_costs: Dict[str, Dict[str, Any]] = {}

    # -- memory accounting -------------------------------------------------

    def sample_device(self, span: Any, store: Any) -> int:
        """Live device bytes held by the store's cache right now, stamped
        onto ``span`` (the closing ``store.load``/``kernel.eval``) and
        folded into the session peak."""
        try:
            live = int(sum(int(e.nbytes) for e in store._cache.values()))
        except Exception:
            return 0
        if live > self.peak_device_bytes:
            self.peak_device_bytes = live
        span.set(device_live_bytes=live)
        return live

    def observe_rss(self) -> int:
        """Process peak RSS in bytes (``ru_maxrss`` is KiB on Linux)."""
        try:
            rss = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss) * 1024
        except Exception:
            return self.peak_rss_bytes
        if rss > self.peak_rss_bytes:
            self.peak_rss_bytes = rss
        return rss

    # -- kernel cost attribution -------------------------------------------

    def attribute_kernel(self, key: Any, *shape: Any,
                         lanes: Optional[Sequence[int]] = None) -> Dict[str, Any]:
        """Predicted cost of one step launch under ``key`` at ``shape``
        (L, EB, W, Q, S, node_pad, V; see ``kernels.ops.step_cost``),
        folded through the roofline.  ``lanes`` lists the lane counts of a
        group of launches that differ only in L (a part mesh's shards, one
        launch each): one launch's cost is then their mean, recorded with
        ``lanes`` when they differ.  Computed once per key, from the first
        call's shapes; call sites invoke it from the branch that marks a
        key's first call."""
        skey = _key_str(key)
        cached = self.kernel_costs.get(skey)
        if cached is not None:
            return cached
        cost: Dict[str, Any] = {"flops": 0.0, "bytes": 0.0,
                                "t_bound_us": 0.0, "dominant": "unknown"}
        try:
            # imported here: the kernels import the core package, whose
            # store and engines import this module
            from ..kernels.ops import step_cost
            group = [shape[0]] if lanes is None else list(lanes)
            costs = [step_cost(L, *shape[1:]) for L in group]
            cost = step_roofline(sum(c[0] for c in costs) / len(costs),
                                 sum(c[1] for c in costs) / len(costs))
            cost["shape"] = dict(zip(("L", "EB", "W", "Q", "S", "node_pad", "V"),
                                     (int(x) for x in shape)))
            if len(set(group)) > 1:
                cost["lanes"] = [int(L) for L in group]
        except Exception as e:  # profiling must never break serving
            cost["cost_error"] = type(e).__name__
        self.kernel_costs[skey] = cost
        return cost

    def stamp_kernel(self, span: Any, key: Any, launches: int) -> None:
        """Write the call's predicted cost -- one launch's cost times the
        call's ``launches`` -- onto a ``kernel.eval`` span (no-op before
        ``attribute_kernel`` ran for the key)."""
        c = self.kernel_costs.get(_key_str(key))
        if c is None:
            return
        n = int(launches)
        span.set(kernel_key=_key_str(key), launches=n,
                 cost_flops=c["flops"] * n, cost_bytes=c["bytes"] * n,
                 cost_t_bound_us=c["t_bound_us"] * n,
                 cost_dominant=c["dominant"])
        if "cost_error" in c:
            span.set(cost_error=c["cost_error"])

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        self.observe_rss()
        return {
            "enabled": True,
            "peak_rss_bytes": self.peak_rss_bytes,
            "peak_device_bytes": self.peak_device_bytes,
            "kernel_costs": {k: dict(v) for k, v in self.kernel_costs.items()},
        }


class SloBurnMonitor:
    """Rolling-window error-budget burn per SLO class.

    Each completion lands as ``observe(slo_class, met)``; the window holds
    the last ``window`` outcomes per class.  Burn rate is

        burn = miss_fraction(window) / error_budget

    burn == 1 means deadline misses exactly consume the budget; burn > 1
    means the budget is burning faster than it accrues (alert-worthy);
    burn == 0 means a clean window.  Shed/rejected requests are not
    deadline outcomes and do not enter the window — shedding is the
    mechanism that *protects* the budget, accounted separately by the
    frontend's shed counters.
    """

    def __init__(self, window: int = 100, error_budget: float = 0.01):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if not (0.0 < error_budget <= 1.0):
            raise ValueError(f"error_budget must be in (0, 1], "
                             f"got {error_budget}")
        self.window = int(window)
        self.error_budget = float(error_budget)
        self._events: Dict[str, Deque[bool]] = {}

    def observe(self, slo_class: str, met: bool) -> None:
        dq = self._events.get(slo_class)
        if dq is None:
            dq = self._events[slo_class] = collections.deque(
                maxlen=self.window)
        dq.append(bool(met))

    def miss_fraction(self, slo_class: str) -> float:
        dq = self._events.get(slo_class)
        if not dq:
            return 0.0
        return sum(1 for met in dq if not met) / len(dq)

    def burn_rate(self, slo_class: str) -> float:
        return self.miss_fraction(slo_class) / self.error_budget

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for cls, dq in self._events.items():
            misses = sum(1 for met in dq if not met)
            out[cls] = {
                "window": len(dq),
                "misses": misses,
                "miss_fraction": misses / len(dq) if dq else 0.0,
                "burn_rate": self.burn_rate(cls),
                "error_budget": self.error_budget,
            }
        return out


def resource_profile_snapshot(session: Any) -> Dict[str, Any]:
    """The serve-JSON ``profile`` block (schema_version 3): session peaks,
    per-kernel predicted costs, tier byte flows, and SLO burn."""
    prof = getattr(session, "profiler", NULL_PROFILER)
    block: Dict[str, Any] = {"enabled": bool(prof.enabled)}
    if not prof.enabled:
        return block
    block.update(prof.snapshot())
    ls = getattr(session, "load_stats", None)
    if ls is not None:
        block["bytes"] = {
            "cold": int(ls.bytes_cold),
            "prefetched": int(ls.bytes_prefetched),
            "disk": int(ls.bytes_disk),
            "host": int(getattr(ls, "bytes_host", 0)),
        }
        backing = getattr(getattr(session, "store", None), "backing", None)
        if backing is not None and hasattr(backing, "bytes_read"):
            block["bytes"]["disk_catalog"] = int(backing.bytes_read)
    burn = getattr(session, "_slo_burn", None)
    if burn:
        block["slo_burn"] = dict(burn)
    return block
