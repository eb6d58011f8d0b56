"""index_ms_per_query (api + index): wall milliseconds of the index's
``query`` calls in the window (timed by the benchmark's proxy around the
index handed to the service; the answers come back as host arrays, so a
call's wall holds its device work) over the real queries they answered."""


def read(run):
    n = run.service["n_requests"]
    return 1e3 * run.index["seconds"] / n if n else None
