"""Per-layer metrics, one reader a file, each named as its metric.

A reader module holds ``LAYER`` (the layer as ``PERF.md`` names it),
``UNIT``, ``MOVES`` (the end-to-end metric it should move) and
``read(ctx) -> float | None``, where ``ctx`` is a
:class:`portbench.harness.MetricContext` (the cell, the traced window's
:class:`portbench.devtrace.Trace`, the steps in it).  A reader that finds
nothing to read returns None and the metric is left out of the result.
"""
