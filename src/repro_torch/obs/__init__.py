"""Span tracing (trace.py): ``Tracer`` and the no-op ``NULL_TRACER`` that
the engine, store and session thread through; export.py writes a tracer
as a Chrome trace and as the serve report's observability block."""
from .export import observability_snapshot, to_chrome_trace, write_chrome_trace
from .trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "Span", "to_chrome_trace",
           "write_chrome_trace", "observability_snapshot"]
