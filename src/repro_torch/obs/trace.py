"""Span tracing with a free disabled path.

The serving stack's hot loops (store lookups, scheduler rounds, kernel
dispatches) run thousands of times per second, so the tracer's OFF state
must cost essentially nothing: ``NULL_TRACER`` is a stateless singleton
whose ``span()`` returns one shared reentrant no-op context manager —
no allocation, no clock read, no lock.  Engines/stores hold a tracer
reference unconditionally and never branch on configuration themselves.

The ON state (``Tracer``) records:

  spans     — named intervals with monotonic ``perf_counter`` t0/t1, a
              process-unique id, the enclosing span's id as parent
              (per-thread stacks: a read-ahead worker's spans parent
              within the worker, never across threads), and free-form
              attributes.  ``span()`` yields the live ``Span`` so call
              sites can attach outcomes discovered mid-block
              (``sp.set(tier="warm")``).  ``add_span`` records a span
              from externally captured timestamps — the scheduler uses
              it for per-query root spans whose lifetime (admission →
              retirement) doesn't nest in any one call frame.
  decisions — point-in-time records explaining a choice: the heuristics
              emit per-partition score breakdowns, the serving front
              end its predicted-vs-deadline admission inputs.  These are
              what ``tools/trace_report.py`` replays to answer "why was
              P3 loaded before P1?".
  anchors   — ``clock.anchor`` events pairing the wall clock
              (``time.time_ns``) with the spans' ``perf_counter``, taken
              when a tracer is built and at the start of every front-end
              ``serve``.  A device profiler stamps its events on the wall
              clock; a span's place there is the linear interpolation
              between the two nearest anchors, so a slew between the two
              clocks over a long trace does not shift spans against the
              device's events.

Appends take a lock (read-ahead threads trace too); span-stack state is
thread-local.  All timestamps share one ``perf_counter`` timebase, so
spans from different threads order correctly in the exported trace.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    """One recorded interval.  ``t0``/``t1`` are ``time.perf_counter()``
    seconds (monotonic, process-wide timebase); ``t1`` is None while the
    span is still open."""

    name: str
    span_id: int
    parent_id: Optional[int]
    t0: float
    t1: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    thread: str = ""

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes discovered mid-span (e.g. the cache tier a
        load resolved to)."""
        self.attrs.update(attrs)
        return self

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


class _NullSpan:
    """The shared no-op span/context-manager: reentrant, stateless, and
    allocation-free — the entire cost of disabled tracing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracing: every method is a no-op.  A single module-level
    instance (``NULL_TRACER``) is shared by every untraced session."""

    enabled = False

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        return _NULL_SPAN

    def add_span(self, name: str, t0: float, t1: float,
                 parent_id: Optional[int] = None, **attrs: Any) -> None:
        return None

    def decision(self, kind: str, **payload: Any) -> None:
        return None

    def anchor(self) -> None:
        return None


NULL_TRACER = NullTracer()


class _SpanCtx:
    """Context manager for one live span: pushes onto the calling
    thread's stack on enter, stamps ``t1`` and records on exit."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span

    def __enter__(self) -> Span:
        self._tracer._push(self._span)
        return self._span

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        sp = self._span
        sp.t1 = time.perf_counter()
        if exc_type is not None:
            sp.attrs.setdefault("error", exc_type.__name__)
        self._tracer._pop(sp)
        return False


class Tracer:
    """Enabled tracing: records spans, events, and decision records.

    One tracer serves one session (and everything threaded under it —
    store, engines, scheduler, front end, delta layer).  Thread-safe:
    each thread nests spans on its own stack; the recorded lists are
    append-only under a lock.
    """

    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._spans: List[Span] = []
        self._decisions: List[Dict[str, Any]] = []
        self._local = threading.local()
        # the trace's epoch: exporters emit timestamps relative to this
        self.t_epoch = time.perf_counter()
        self.anchor()

    # -- recording ----------------------------------------------------------

    def span(self, name: str, **attrs: Any) -> _SpanCtx:
        """``with tracer.span("store.load", pid=3) as sp: ...`` — records
        the block as one span, parented under the thread's innermost
        open span."""
        sp = Span(name=name, span_id=next(self._ids),
                  parent_id=self.current_span_id,
                  t0=time.perf_counter(), attrs=dict(attrs),
                  thread=threading.current_thread().name)
        return _SpanCtx(self, sp)

    def add_span(self, name: str, t0: float, t1: float,
                 parent_id: Optional[int] = None, **attrs: Any) -> Span:
        """Record a span from timestamps the caller captured itself
        (``time.perf_counter()`` seconds, same timebase as ``span``)."""
        sp = Span(name=name, span_id=next(self._ids), parent_id=parent_id,
                  t0=float(t0), t1=float(t1), attrs=dict(attrs),
                  thread=threading.current_thread().name)
        with self._lock:
            self._spans.append(sp)
        return sp

    def decision(self, kind: str, **payload: Any) -> None:
        """Record one decision: a heuristic ranking's per-partition score
        breakdown, a frontend admission verdict, ...  Stamped with the
        current time and the enclosing span so reports can correlate
        decisions with the work they caused."""
        rec = {"kind": kind, "ts": time.perf_counter(),
               "span_id": self.current_span_id}
        rec.update(payload)
        with self._lock:
            self._decisions.append(rec)

    def event(self, name: str, **attrs: Any) -> None:
        """A zero-duration marker (exported as an instant event)."""
        t = time.perf_counter()
        self.add_span(name, t, t, parent_id=self.current_span_id, **attrs)

    def anchor(self) -> None:
        """Record one ``clock.anchor`` event: ``wall_ns`` from
        ``time.time_ns()`` and ``perf_ns``, the ``perf_counter_ns()``
        midpoint of the read that bracketed it most tightly of three."""
        best = None
        for _ in range(3):
            p0 = time.perf_counter_ns()
            wall = time.time_ns()
            p1 = time.perf_counter_ns()
            if best is None or p1 - p0 < best[0]:
                best = (p1 - p0, wall, (p0 + p1) // 2)
        self.event("clock.anchor", wall_ns=best[1], perf_ns=best[2])

    # -- introspection ------------------------------------------------------

    @property
    def current_span_id(self) -> Optional[int]:
        stack = getattr(self._local, "stack", None)
        return stack[-1].span_id if stack else None

    @property
    def spans(self) -> List[Span]:
        """Snapshot of every *closed* span recorded so far."""
        with self._lock:
            return list(self._spans)

    @property
    def decisions(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._decisions)

    def span_totals(self) -> Dict[str, Dict[str, float]]:
        """Per-name count and total seconds — the summary the JSON
        report embeds."""
        totals: Dict[str, Dict[str, float]] = {}
        for sp in self.spans:
            agg = totals.setdefault(sp.name, {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += sp.duration_s
        return totals

    # -- internals (called by _SpanCtx) -------------------------------------

    def _push(self, sp: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(sp)

    def _pop(self, sp: Span) -> None:
        stack = getattr(self._local, "stack", None)
        if stack and stack[-1] is sp:
            stack.pop()
        elif stack and sp in stack:       # mis-nested exit: drop through
            stack.remove(sp)
        with self._lock:
            self._spans.append(sp)
