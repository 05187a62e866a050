"""The residency invariant shared by ``RunStats`` validation
(core/metrics.py) and the chip smoke run.

This is the part of the JAX package's ``obs/metrics.py`` that the
out-of-core store needs.  The metrics registry that module also holds
(counters, gauges, histograms and the ``ingest_*`` adapters) is ported
with the metrics-registry item of ROADMAP.md.
"""
from __future__ import annotations

from typing import Dict, Optional


def validate_residency(cold: Optional[int], warm: Optional[int],
                       prefetch_hits: Optional[int],
                       n_loads: int) -> Dict[str, int]:
    """The residency classification invariant, shared by ``RunStats``
    validation (core/metrics.py) and the benchmarks: every recorded
    partition load is exactly one of {cold, demand-warm, prefetch-hit}
    (``warm_loads`` INCLUDES prefetch hits by definition, so the
    disjoint classes are cold + (warm − prefetch_hits) + prefetch_hits
    and must sum to ``n_loads``).  Returns the classified counts;
    raises ``ValueError`` on miscounted instrumentation."""
    if cold is None or warm is None:
        raise ValueError("residency counters absent")
    ph = int(prefetch_hits or 0)
    cold, warm = int(cold), int(warm)
    if min(cold, warm, ph) < 0:
        raise ValueError(
            f"negative residency counter: cold={cold} warm={warm} "
            f"prefetch_hits={ph}")
    if ph > warm:
        raise ValueError(
            f"prefetch_hits ({ph}) exceed warm_loads ({warm}) — a "
            f"prefetch hit must also count as a warm load")
    if cold + (warm - ph) + ph != n_loads:
        raise ValueError(
            f"cold_loads + warm_loads + prefetch_hits classification "
            f"does not cover the load sequence: cold={cold} + "
            f"demand_warm={warm - ph} + prefetch_hits={ph} != "
            f"n_loads={n_loads}")
    return {"cold": cold, "demand_warm": warm - ph, "prefetch_hits": ph,
            "n_loads": n_loads}
