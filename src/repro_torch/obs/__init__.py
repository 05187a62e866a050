"""Zero-dependency observability: span tracing, a unified metrics
registry, resource profiling, and exporters.

  trace.py   — ``Tracer``: span context managers with ids, parents,
               monotonic timestamps and attributes, plus decision records;
               the disabled path is ``NULL_TRACER``.
  metrics.py — ``MetricsRegistry``: counters, gauges and histograms that
               absorb the store's, host tier's, delta layer's, scheduler's
               and front end's counters into one exportable namespace.
  profile.py — ``ResourceProfiler``: device live bytes per span, session
               peaks, the frontier step's predicted cost on every
               ``kernel.eval`` span (H100 roofline), and
               ``SloBurnMonitor``; disabled path ``NULL_PROFILER``.
  export.py  — Chrome trace-event JSON, Prometheus text exposition, and
               the serve report's observability block.

``tools/trace_report.py`` reads the Chrome trace (``--check``, ``--cost``).
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, \
    ingest_frontend, ingest_load_stats, ingest_schedule, ingest_session, \
    validate_residency
from .trace import NULL_TRACER, NullTracer, Span, Tracer
from .profile import NULL_PROFILER, NullResourceProfiler, \
    ResourceProfiler, SloBurnMonitor, resource_profile_snapshot
from .export import observability_snapshot, to_chrome_trace, \
    to_prometheus_text, write_chrome_trace, write_prometheus

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span",
    "ResourceProfiler", "NullResourceProfiler", "NULL_PROFILER",
    "SloBurnMonitor", "resource_profile_snapshot",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "ingest_frontend", "ingest_load_stats", "ingest_schedule",
    "ingest_session", "validate_residency",
    "to_chrome_trace", "write_chrome_trace", "to_prometheus_text",
    "write_prometheus", "observability_snapshot",
]
