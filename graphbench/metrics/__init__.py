"""One reader per per-layer metric family, found by name (``graphbench.bench.metric_reader``)."""
