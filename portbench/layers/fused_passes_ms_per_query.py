"""fused_passes_ms_per_query (index.nsimplex_index): milliseconds per
query of the batch's fused passes, inclusive: the projection with its copy
to the host (``nsimplex.project``), pass A, K2 and the k-th bound's copy
(``nsimplex.pass_a``), pass B, K3 and its copy (``nsimplex.pass_b``)."""

from portbench.layers._spans import ms_per_query


def read(run):
    return ms_per_query(run, ("nsimplex.project", "nsimplex.pass_a", "nsimplex.pass_b"))
