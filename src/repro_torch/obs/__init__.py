"""Span tracing (trace.py): ``Tracer`` and the no-op ``NULL_TRACER`` that
the engine, store and session thread through."""
from .trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "Span"]
