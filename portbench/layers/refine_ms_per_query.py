"""refine_ms_per_query (metrics.supermetrics): milliseconds per query of
the refinement's true-metric calls, inclusive: the row gather, the metric
(K5 for sqrt-JSD) and the copy of the distances to the host
(``metric.refine``)."""

from portbench.layers._spans import ms_per_query


def read(run):
    return ms_per_query(run, ("metric.refine",))
