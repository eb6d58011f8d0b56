"""Per-layer metrics: one module each, named as the metric, with
``read(run) -> float | None`` over a finished run (``portbench.bench.Run``).
A reader that finds nothing to read returns None, and the metric is left
out of the result line."""
