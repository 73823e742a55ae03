"""Per-layer metric readers, one module a metric, named as in
BENCHMARK.json's ``per_layer``.  ``read(readings)`` takes a
``trace.Readings`` and returns ``{"value": ..., "unit": ...}``, or None
where the run has nothing to read for it."""
