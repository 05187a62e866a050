"""SLO burn-rate monitoring: ``SloBurnMonitor``, the rolling window of
deadline outcomes per SLO class that the serving front end
(serving/frontend.py) reports.

A copy of the JAX package's ``obs/profile.SloBurnMonitor``, logic
unchanged.  That module's ``ResourceProfiler`` (device-memory sampling
and kernel cost attribution) comes with the metrics registry and
profiling; nothing here imports it.
"""
from __future__ import annotations

import collections
from typing import Any, Deque, Dict


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
