"""overflow_select_ms_per_query (index.nsimplex_index): milliseconds per
query of the overflow route's host selection over all N bounds (widening,
partition, candidate sort, the refinement loop), self time: the
true-metric calls under it (``metric.refine``) are left out
(``nsimplex.overflow.select``)."""

from portbench.layers._spans import ms_per_query


def read(run):
    return ms_per_query(run, ("nsimplex.overflow.select",), part="self_s")
