"""Per-layer readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``.  Each has ``read(rec) -> float | None``: ``rec`` is the
traced run's record (``port_bench/harness.py`` ``trace_record``), and a
reader that finds nothing to read returns None, so that the metric is left
out of the line (never 0 for a share of a roofline or a peak)."""
