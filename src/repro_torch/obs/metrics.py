"""A unified metrics registry for the serving stack's ad-hoc counters.

Counters with the same meaning live all over the repo under different
names and shapes: ``LoadStats`` fields on the store (cold/warm/prefetch/
disk/read-ahead, core/store.py + storage/host_cache.py), pending-delta
and compaction counts on the mutable directory (storage/deltas.py),
round/batch-occupancy lists on the scheduler (core/scheduler.py), and
admit/degrade/defer/shed dicts on the serving front end
(serving/frontend.py).  This module gives them ONE namespace —
``repro_<subsystem>_<what>`` — without rewriting any hot path: the
sources keep their counters (every existing test and report stays
valid), and ``ingest_*`` absorbs them into the registry at snapshot
time.  Exporters (obs/export.py) then see one flat, label-aware
metric space regardless of which subsystems ran.

Three instrument kinds, deliberately minimal:

  Counter   — monotone total (``inc``); ingestion ``set_total``s it to
              the source's absolute value.
  Gauge     — last-write-wins level (``set``).
  Histogram — fixed-bucket counts + sum (``observe``), Prometheus
              cumulative-bucket semantics on export.

Everything is plain Python; thread safety is a single lock per registry
(ingestion and exporting are report-time operations, never hot).

A copy of the JAX package's ``obs/metrics.py``, logic unchanged: the
metric names keep the ``repro_`` prefix, so both packages' Prometheus
files compare line for line.
"""
from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0)


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """A monotone total."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def set_total(self, v: float) -> None:
        """Absorb an externally maintained absolute total (ingestion:
        the source counter is authoritative, the registry mirrors it)."""
        self.value = float(v)


class Gauge:
    """A level: last write wins."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Histogram:
    """Fixed upper-bound buckets, a count, and a sum."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.counts = [0] * len(self.buckets)   # per-bucket (non-cumulative)
        self.overflow = 0                        # > last bucket (+Inf lane)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        i = bisect.bisect_left(self.buckets, v)
        if i < len(self.buckets):
            self.counts[i] += 1
        else:
            self.overflow += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """Prometheus ``le`` semantics: (upper_bound, cumulative count)."""
        out, acc = [], 0
        for b, c in zip(self.buckets, self.counts):
            acc += c
            out.append((b, acc))
        return out


class MetricsRegistry:
    """Name+labels → instrument.  ``counter``/``gauge``/``histogram``
    create on first use and return the live instrument."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], Any] = {}
        self._help: Dict[str, str] = {}
        self._labels: Dict[Tuple[str, Tuple], Dict[str, str]] = {}

    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **kw: Any):
        key = (name, _labelkey(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help=help, **kw)
                self._metrics[key] = m
                self._labels[key] = dict(labels)
                if help:
                    self._help.setdefault(name, help)
            return m

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels: str) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def collect(self) -> List[Tuple[Any, Dict[str, str]]]:
        """Every (instrument, labels) pair, stable name-then-label order."""
        with self._lock:
            keys = sorted(self._metrics, key=lambda k: (k[0], k[1]))
            return [(self._metrics[k], dict(self._labels[k])) for k in keys]

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-safe dump: scalar metrics flat (labelled ones keyed
        ``name{k=v}``), histograms as bucket/count/sum dicts."""
        out: Dict[str, Any] = {}
        for m, labels in self.collect():
            key = m.name if not labels else (
                m.name + "{" + ",".join(f"{k}={v}" for k, v in
                                        sorted(labels.items())) + "}")
            if m.kind == "histogram":
                out[key] = {"count": m.count, "sum": m.sum,
                            "buckets": {str(b): c for b, c
                                        in m.cumulative()},
                            "overflow": m.overflow}
            else:
                v = m.value
                out[key] = int(v) if float(v).is_integer() else v
        return out


# -- ingestion: absorb the repo's existing ad-hoc counters ------------------

_LOAD_STAT_METRICS = (
    # (LoadStats field, unified metric name, help)
    ("hits", "repro_store_warm_loads_total",
     "device-cache hits (entry already resident)"),
    ("misses", "repro_store_cold_loads_total",
     "device-cache misses (device_put on the critical path)"),
    ("evictions", "repro_store_evictions_total",
     "device-LRU entries dropped to fit capacity"),
    ("prefetch_issued", "repro_store_prefetch_issued_total",
     "prefetch() calls that actually staged"),
    ("prefetch_hits", "repro_store_prefetch_hits_total",
     "gets served by a previously prefetched entry"),
    ("released", "repro_store_released_total",
     "entries explicitly release()d (scheduler retirement)"),
    ("bytes_cold", "repro_store_bytes_cold_total",
     "bytes transferred by cold loads"),
    ("bytes_prefetched", "repro_store_bytes_prefetched_total",
     "bytes transferred off the critical path"),
    ("disk_reads", "repro_store_disk_reads_total",
     "shard reads issued against the disk tier"),
    ("read_ahead_issued", "repro_store_read_ahead_issued_total",
     "background-thread shard reads started"),
    ("read_ahead_hits", "repro_store_read_ahead_hits_total",
     "host gets served by a completed/in-flight read-ahead"),
    ("bytes_disk", "repro_store_bytes_disk_total",
     "bytes read off disk (demand + read-ahead)"),
    ("bytes_host", "repro_store_host_bytes_total",
     "bytes served out of the host LRU tier to device staging"),
    ("host_evictions", "repro_store_host_evictions_total",
     "host-LRU entries dropped to fit capacity"),
    ("delta_overlays", "repro_deltas_overlay_rebuilds_total",
     "bundles rebuilt from a generation view's delta overlay"),
)


def ingest_load_stats(reg: MetricsRegistry, stats: Any) -> None:
    """Absorb a ``LoadStats`` (core/store.py) into the unified namespace."""
    for field, name, help in _LOAD_STAT_METRICS:
        reg.counter(name, help=help).set_total(getattr(stats, field))


def ingest_schedule(reg: MetricsRegistry, loads: Sequence[int],
                    batch_sizes: Sequence[int]) -> None:
    """Absorb a scheduler's workload-level load sequence: total rounds
    plus the batch-occupancy histogram (jobs advanced per load)."""
    reg.counter("repro_scheduler_loads_total",
                help="workload-level partition loads").set_total(len(loads))
    h = reg.histogram("repro_scheduler_batch_occupancy",
                      help="jobs advanced per workload-level load",
                      buckets=(1, 2, 4, 8, 16, 32, 64))
    for b in batch_sizes:
        h.observe(b)


def ingest_frontend(reg: MetricsRegistry, counters: Dict[str, int],
                    shed_by_reason: Dict[str, int]) -> None:
    """Absorb the serving front end's admission/degrade/defer/shed
    counters (per run; serve.py calls this once after ``serve``)."""
    for key, n in sorted(counters.items()):
        reg.counter(f"repro_frontend_{key}_total",
                    help=f"front-end requests {key}").set_total(n)
    for reason, n in sorted(shed_by_reason.items()):
        reg.counter("repro_frontend_shed_reason_total",
                    help="sheds by reason", reason=reason).set_total(n)


def ingest_session(reg: MetricsRegistry, session: Any) -> None:
    """One call absorbs everything a ``GraphSession`` can observe: its
    store's ``LoadStats``, the delta layer's write-pressure counters,
    per-session serving totals, and (if the session served SLO traffic)
    the front-end counters it accumulated."""
    ingest_load_stats(reg, session.load_stats)
    reg.counter("repro_session_queries_served_total",
                help="queries absorbed into the workload profile"
                ).set_total(session._queries_served)
    reg.counter("repro_session_answers_served_total",
                help="answer rows returned").set_total(
                    session._answers_served)
    mdir = getattr(session, "_mdir", None)
    if mdir is not None:
        reg.gauge("repro_deltas_generation",
                  help="latest published shard generation").set(
                      mdir.generation)
        reg.gauge("repro_deltas_pending",
                  help="delta records not yet folded").set(
                      int(mdir.pending_counts().sum()))
        reg.counter("repro_deltas_compactions_total",
                    help="log->shard folds published").set_total(
                        mdir.compactions)
    backing = getattr(getattr(session, "store", None), "backing", None)
    if backing is not None and hasattr(backing, "bytes_read"):
        reg.counter("repro_store_disk_bytes_total",
                    help="bytes the disk catalog deserialized (demand + "
                         "read-ahead + overlay rebuild source reads)"
                    ).set_total(backing.bytes_read)
    prof = getattr(session, "profiler", None)
    if prof is not None and getattr(prof, "enabled", False):
        prof.observe_rss()
        reg.gauge("repro_session_peak_rss_bytes",
                  help="process peak RSS observed (ru_maxrss)").set(
                      prof.peak_rss_bytes)
        reg.gauge("repro_session_peak_device_bytes",
                  help="peak live device bytes held by the partition "
                       "store").set(prof.peak_device_bytes)
    for cls, snap in sorted(getattr(session, "_slo_burn", {}).items()):
        reg.gauge("repro_frontend_slo_burn_rate",
                  help="rolling-window error-budget burn rate per SLO "
                       "class (miss_fraction / error_budget; >1 means "
                       "the budget burns faster than it accrues)",
                  slo_class=cls).set(float(snap.get("burn_rate", 0.0)))
    if session._slo_counters or session._slo_shed_reasons:
        ingest_frontend(reg, session._slo_counters,
                        session._slo_shed_reasons)


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
