"""overflow_bounds_ms_per_query (index.nsimplex_index): milliseconds per
query of the overflow route's bounds, inclusive: K1 for one query and the
copy of its two (N,) f64 bound rows to the host
(``nsimplex.overflow.bounds``)."""

from portbench.layers._spans import ms_per_query


def read(run):
    return ms_per_query(run, ("nsimplex.overflow.bounds",))
