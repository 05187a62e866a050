"""Straggler watchdog: per-step wall-time tracking with robust outlier
flagging.

At cluster scale the launcher runs one of these per host; a step whose
duration exceeds ``threshold`` x rolling median is flagged (the fleet
controller would reschedule or evict the host — here we log and count,
and the training loop exposes the counters in its metrics).  This mirrors
the paper's m < required(i) analysis: progress continues with whatever
subset of workers is fast, and the quota/backpressure design in
MapReduceMP tolerates partial participation per iteration.

A copy of the JAX package's module (it uses no jax), logic unchanged.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Optional


@dataclasses.dataclass
class StepWatchdog:
    window: int = 50
    threshold: float = 3.0        # x median
    _times: Deque[float] = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=200))
    slow_steps: int = 0
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.time()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        dt = time.time() - self._t0
        self._t0 = None
        flagged = self.is_straggler(dt)
        self._times.append(dt)
        if flagged:
            self.slow_steps += 1
        return dt

    def is_straggler(self, dt: float) -> bool:
        if len(self._times) < max(5, self.window // 10):
            return False
        med = sorted(self._times)[len(self._times) // 2]
        return dt > self.threshold * med

    @property
    def median(self) -> float:
        if not self._times:
            return 0.0
        return sorted(self._times)[len(self._times) // 2]
