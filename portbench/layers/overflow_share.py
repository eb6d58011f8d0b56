"""overflow_share (index.nsimplex_index): share of the query rows the index
executed in the window (padding included) that took the per-query overflow
route, from the index's ``overflow_queries`` counter."""


def read(run):
    rows, over = run.index["rows"], run.index["overflow"]
    return 100.0 * over / rows if rows and over is not None else None
