"""Per-layer metric readers, one module a metric named as in
BENCHMARK.json: ``UNIT`` and ``read(trace)``, which returns the metric
or None where the trace holds nothing to read."""
