"""What a ``--trace 1`` run reads over its window.

A traced run serves the same window as an untraced one, with the
program's own ``Tracer`` (``repro_torch.obs.trace``) on the session.
Over the whole window it also

  * runs ``torch.profiler`` with CUDA activity only (no per-op host
    recording, so the host loop keeps its pace), for the device's
    kernels, copies and memsets;
  * wraps the frontier step (``repro_torch.kernels.ops.frontier_step``,
    which the evaluators call once a loop) from outside, to count each
    launch's lanes, active bindings and the adjacency entries of their
    frontier vertices (``graphbench.roofline``).  The counting runs on a
    stream of its own, marked by one ``spin_kernel`` launch, and the
    readers leave that stream out of every device figure.

The profiled slice is the window: it starts after set-up and stops once
the window's work is done, each after a device sync.  Profiler timestamps are wall-clock nanoseconds; host spans are
``perf_counter`` seconds, put on the same clock by the offset between the
two taken at the slice's start.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch

STEP_KERNEL = "frontier_step_kernel"
MARK_KERNEL = "spin_kernel"


class WindowRecorder:
    """Profiles from ``start()`` to ``stop()`` and counts the step's work
    in between; see the module docstring."""

    def __init__(self, device: torch.device):
        from repro_torch.kernels import build
        self._build = build
        self.device = device
        self.cuda = device.type == "cuda"
        self.state = "wait"
        self._orig = None
        self._deg: Dict[tuple, torch.Tensor] = {}
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.lanes = 0
        self.launches = 0
        self.result: Optional[dict] = None

    # -- the wrapper ----------------------------------------------------------

    def start(self) -> None:
        """Wrap the step and start profiling."""
        from repro_torch.kernels import ops
        self._ops = ops
        self._orig = ops.frontier_step
        ops.frontier_step = self._step
        self._start()

    def stop(self) -> None:
        """Stop profiling and put the step back."""
        if self.state == "on":
            self._stop()
        if self._orig is not None:
            self._ops.frontier_step = self._orig
            self._orig = None

    def _step(self, inv, wr, ws, lidx, sel, m, out):
        res = self._orig(inv, wr, ws, lidx, sel, m, out)
        if self.state == "on":
            self._count(inv, lidx, sel, m)
        return res

    # -- profiling ------------------------------------------------------------

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CUDA] if self.cuda \
            else [torch.profiler.ProfilerActivity.CPU]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        self._entries, self._bindings = zero.clone(), zero.clone()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        if self.cuda:
            with torch.cuda.stream(self.stream):
                torch.cuda._sleep(1000)
        self.launches0 = self._build.LAUNCHES["fused_frontier"]
        self.wall_off_ns = time.time_ns() - time.perf_counter_ns()
        self.t0 = time.perf_counter()
        self.state = "on"

    def _stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        launches = self._build.LAUNCHES["fused_frontier"] - self.launches0
        self._prof.__exit__(None, None, None)
        self.state = "done"
        events = []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            events.append((e.name(), int(e.start_ns()), int(e.duration_ns()),
                           int(e.device_resource_id())))
        mark = [ev[3] for ev in events if MARK_KERNEL in ev[0]]
        t0_ns = int(self.t0 * 1e9) + self.wall_off_ns
        t1_ns = int(t1 * 1e9) + self.wall_off_ns
        self.result = {
            "device": self.cuda,
            "t0": self.t0, "t1": t1, "wall_off_ns": self.wall_off_ns,
            "t0_ns": t0_ns, "t1_ns": t1_ns,
            "step_launches": int(launches),
            "recorded_launches": self.launches,
            "lanes": self.lanes,
            "entries": int(self._entries.item()),
            "bindings": int(self._bindings.item()),
            # the recorder's own stream, when its mark was found
            "side_stream": mark[0] if mark else None,
            "events": [ev for ev in events
                       if not mark or ev[3] != mark[0]],
        }
        self._prof = None

    def _degrees(self, table: torch.Tensor) -> torch.Tensor:
        """Real entries in each row of an ELL table (padding is -1)."""
        key = (table.data_ptr(), tuple(table.shape))
        got = self._deg.get(key)
        if got is None:
            got = (table >= 0).sum(1)
            self._deg[key] = got
        return got

    def _count(self, inv, lidx, sel, m) -> None:
        L = sel.shape[0]
        self.lanes += int(L)
        self.launches += 1
        ctx = torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with ctx:
            deg = self._degrees(inv.tables[0])
            rows = (lidx.gather(1, sel).long().clamp(0, inv.node_pad - 1)
                    + inv.lane[:, :1].long() * inv.node_pad)
            self._entries += (deg[rows] * m).sum()
            self._bindings += m.sum()
        if self.cuda:
            for t in (lidx, sel, m, inv.lane):
                t.record_stream(self.stream)


# -- reading the profile -------------------------------------------------------

def union_intervals(events: List[tuple], lo: int, hi: int) -> List[List[int]]:
    """The union of the events' [start, end) clipped to [lo, hi), sorted."""
    spans = sorted((max(s, lo), min(s + d, hi)) for _, s, d, _ in events
                   if s + d > lo and s < hi)
    out: List[List[int]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def is_kernel(name: str) -> bool:
    low = name.lower()
    return not (low.startswith("memcpy") or low.startswith("memset")
                or MARK_KERNEL in name)


def busy_s(sl: dict) -> Optional[float]:
    if not sl or not sl["device"] or sl["side_stream"] is None:
        return None
    iv = union_intervals(sl["events"], sl["t0_ns"], sl["t1_ns"])
    return sum(e - s for s, e in iv) / 1e9


def breakdown(sl: dict, spans: list) -> Optional[dict]:
    """The ten device operations with the most time in the window, and the
    idle time by the innermost program span the host was in."""
    if not sl or not sl["device"] or sl["side_stream"] is None:
        return None
    by_op: Dict[str, float] = {}
    for name, _, dur, _ in sl["events"]:
        if MARK_KERNEL not in name:
            by_op[name] = by_op.get(name, 0.0) + dur / 1e9
    iv = union_intervals(sl["events"], sl["t0_ns"], sl["t1_ns"])
    gaps, prev = [], sl["t0_ns"]
    for s, e in iv + [[sl["t1_ns"], sl["t1_ns"]]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gap = np.asarray(gaps, dtype=np.int64).reshape(-1, 2)
    mid = (gap[:, 0] + gap[:, 1]) // 2
    order = np.argsort(mid)
    mid, gap = mid[order], gap[order]
    # the innermost span over each gap's midpoint: the shortest spans
    # claim their gaps first
    off = sl["wall_off_ns"]
    host = [(int(sp.t0 * 1e9) + off, int(sp.t1 * 1e9) + off, sp.name)
            for sp in spans if sp.t1 is not None]
    host = [h for h in host if h[1] > sl["t0_ns"] and h[0] < sl["t1_ns"]]
    owner = np.full(mid.shape[0], -1, dtype=np.int64)
    names = sorted({h[2] for h in host})
    for s, e, name in sorted(host, key=lambda h: h[1] - h[0]):
        lo, hi = np.searchsorted(mid, [s, e])
        part = owner[lo:hi]
        part[part < 0] = names.index(name)
    idle: Dict[str, float] = {}
    for i in range(-1, len(names)):
        secs = float((gap[owner == i, 1] - gap[owner == i, 0]).sum()) / 1e9
        if secs > 0:
            idle[names[i] if i >= 0 else "outside spans"] = secs
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:10]]
    return {"device_ops": top(by_op), "idle_gaps": top(idle)}
