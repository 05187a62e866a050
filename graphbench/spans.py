"""The program's own spans, read over the served window, and placed on
the profiler's clock.

The host-read metrics take the spans that start and end inside the
window (``[served.t0, served.t1]``, as ``round_ms`` does), and read only
runs on the card: the cell's numbers are the card's, and a CPU run's
evaluator is the kernels' plain versions.  A program that lacks a span or
a counter leaves the metric out (None), never raises.

Clocks: host spans are ``perf_counter`` seconds; the profiler's events
are wall-clock nanoseconds.  The port's tracer records ``clock.anchor``
events (``wall_ns`` and ``perf_ns``, read together) when it is built and
at the start of every front-end ``serve``.  ``anchor_clock`` maps a host
time to the profiler's clock by linear interpolation between the two
nearest anchors (outside them, the nearest anchor's offset);
``offset_clock`` is the recorder's one offset, taken at the slice's
start (``graphbench.tracing``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from graphbench.tracing import STEP_KERNEL, union_intervals

ANCHOR = "clock.anchor"
# how far a step kernel may lie outside the evaluator call that launched
# it, on the mapped clock, before the clock check counts it
OVERHANG_TOL_NS = 100_000

Clock = Callable[[object], np.ndarray]


def on_card(ctx) -> bool:
    sl = ctx.get("slice")
    return bool(sl and sl["device"])


def in_window(ctx, name: str) -> list:
    """Closed spans named ``name`` (or starting with it, where it ends
    in a dot) that start and end inside the served window."""
    t0, t1 = ctx["served"].t0, ctx["served"].t1
    match = (lambda n: n.startswith(name)) if name.endswith(".") else (lambda n: n == name)
    return [sp for sp in ctx["spans"] if match(sp.name) and sp.t1 is not None
            and t0 <= sp.t0 and sp.t1 <= t1]


def descendants(spans: list, ancestors: list, prefix: str) -> Dict[int, list]:
    """For each span of ``ancestors``, the spans of ``spans`` whose names
    start with ``prefix`` and that descend from it (by ``parent_id``)."""
    by_id = {sp.span_id: sp for sp in spans}
    want = {sp.span_id: [] for sp in ancestors}
    for sp in spans:
        if not sp.name.startswith(prefix) or sp.t1 is None:
            continue
        up = by_id.get(sp.parent_id)
        while up is not None and up.span_id not in want:
            up = by_id.get(up.parent_id)
        if up is not None:
            want[up.span_id].append(sp)
    return want


# -- clocks ----------------------------------------------------------------------

def anchors(spans: list) -> Optional[np.ndarray]:
    """The ``clock.anchor`` events as an int64 [n, 2] array of (perf_ns,
    wall_ns), sorted by perf_ns; None where the program records none."""
    got = sorted({(int(sp.attrs["perf_ns"]), int(sp.attrs["wall_ns"]))
                  for sp in spans if sp.name == ANCHOR
                  and "perf_ns" in sp.attrs and "wall_ns" in sp.attrs})
    return np.asarray(got, dtype=np.int64) if got else None


def anchor_clock(spans: list) -> Optional[Clock]:
    """Host seconds to the profiler's nanoseconds through the anchors; the
    offsets stay in int64, so no wall-clock magnitude passes a float."""
    got = anchors(spans)
    if got is None:
        return None
    perf = got[:, 0]
    off = got[:, 1] - perf
    rel = (off - off[0]).astype(np.float64)
    xp = perf.astype(np.float64)

    def to_ns(t) -> np.ndarray:
        t_ns = np.rint(np.asarray(t, dtype=np.float64) * 1e9).astype(np.int64)
        return t_ns + off[0] + np.rint(np.interp(t_ns.astype(np.float64), xp, rel)).astype(np.int64)
    return to_ns


def offset_clock(sl: dict) -> Clock:
    """The recorder's mapping: one offset for the whole slice."""
    off = int(sl["wall_off_ns"])

    def to_ns(t) -> np.ndarray:
        return (np.asarray(t, dtype=np.float64) * 1e9).astype(np.int64) + off
    return to_ns


def drift_ns(spans: list, t0: float, t1: float) -> Optional[int]:
    """How far the wall clock ran ahead of ``perf_counter`` between the
    first and the last anchor inside [t0, t1] (host seconds)."""
    got = anchors(spans)
    if got is None:
        return None
    got = got[(got[:, 0] >= t0 * 1e9) & (got[:, 0] <= t1 * 1e9)]
    if got.shape[0] < 2:
        return None
    return int((got[-1, 1] - got[0, 1]) - (got[-1, 0] - got[0, 0]))


def step_overhang(sl: dict, spans: list, clock: Clock) -> dict:
    """The clock check: every step kernel must lie inside the mapped
    interval of some ``kernel.eval`` span (each evaluator loop ends in a
    host sync, each call in ``lane_outputs``).  The number of step
    kernels, how many lie more than ``OVERHANG_TOL_NS`` outside every
    span, and the worst overhang, in microseconds."""
    evals = sorted((sp.t0, sp.t1) for sp in spans if sp.name == "kernel.eval" and sp.t1 is not None)
    steps = [(s, s + d) for name, s, d, _ in sl["events"] if STEP_KERNEL in name]
    if not evals or not steps:
        return {"steps": len(steps), "outside": None, "worst_us": None}
    iv = np.asarray(evals, dtype=np.float64)
    a, b = clock(iv[:, 0]), clock(iv[:, 1])
    ks = np.asarray(steps, dtype=np.int64)
    i = np.searchsorted(a, ks[:, 0], side="right") - 1
    over = np.full(ks.shape[0], np.iinfo(np.int64).max, dtype=np.int64)
    for j in (i, i + 1):
        ok = (j >= 0) & (j < a.shape[0])
        jj = np.clip(j, 0, a.shape[0] - 1)
        o = np.maximum(np.maximum(a[jj] - ks[:, 0], ks[:, 1] - b[jj]), 0)
        over = np.where(ok, np.minimum(over, o), over)
    return {"steps": int(ks.shape[0]), "outside": int((over > OVERHANG_TOL_NS).sum()),
            "worst_us": float(over.max()) / 1e3}


def idle_while(sl: dict, host: List[List[int]], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] in which the card ran none of the slice's
    events and the host was inside one of ``host`` (disjoint, sorted)."""
    h = np.clip(np.asarray(host, dtype=np.int64).reshape(-1, 2), lo, hi)
    total = int((h[:, 1] - h[:, 0]).sum())
    busy = np.asarray(union_intervals(sl["events"], lo, hi), dtype=np.int64).reshape(-1, 2)
    if not busy.shape[0] or not total:
        return total
    bs, width = busy[:, 0], busy[:, 1] - busy[:, 0]
    cum = np.concatenate([[0], np.cumsum(width)])

    def busy_before(t: np.ndarray) -> np.ndarray:
        k = np.searchsorted(bs, t, side="right") - 1
        kk = np.maximum(k, 0)
        return np.where(k >= 0, cum[kk] + np.clip(t - bs[kk], 0, width[kk]), 0)
    return total - int((busy_before(h[:, 1]) - busy_before(h[:, 0])).sum())


def subtract(outer: List[List[int]], inner: List[List[int]]) -> List[List[int]]:
    """``outer`` (disjoint, sorted) less the union of ``inner``."""
    cut = union_intervals([(None, s, e - s, None) for s, e in inner],
                          min((s for s, _ in outer), default=0),
                          max((e for _, e in outer), default=0))
    out, k = [], 0
    for s, e in outer:
        while k < len(cut) and cut[k][1] <= s:
            k += 1
        j, cur = k, s
        while j < len(cut) and cut[j][0] < e:
            if cut[j][0] > cur:
                out.append([cur, cut[j][0]])
            cur = max(cur, cut[j][1])
            j += 1
        if cur < e:
            out.append([cur, e])
    return out


def self_time(sp, kids: list) -> float:
    """``sp``'s duration less the part of it that ``kids`` cover (host
    seconds)."""
    return sum(e - s for s, e in subtract([[sp.t0, sp.t1]], [[k.t0, k.t1] for k in kids]))
