"""Metric readers, one module a metric, found by the part of the metric's
name before its first dot (``launches.gnn_infer`` reads with
``launches.py``). Each module has ``read(rec)``, which returns the number
or None when it finds nothing to read; ``rec`` is a
:class:`bench.harness.Record`."""
