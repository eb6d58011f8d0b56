"""What the ``program_span`` readers share: the program's own spans
(``repro_torch.tracing``) of the batches the service ran in a finished
run's window.  The program records them while the profiler of a
``--trace 1`` run records (or after ``tracing.enable()``)."""


def batch_spans(run):
    """(the real requests of the ``service.batch`` spans that opened inside
    the window, every span of those batches' traces), or None where there
    is none: spans were off, or the program has no ``repro_torch.tracing``."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = [s for s in tracing.snapshot() if s.t0 >= run.window.t_open]
    batches = [s for s in spans if s.name == "service.batch"]
    requests = sum(s.attrs["requests"] for s in batches)
    if not requests:
        return None
    traces = {s.trace for s in batches}
    return requests, [s for s in spans if s.trace in traces]


def ms_per_query(run, names, part: str = "total_s"):
    """Milliseconds per real request of the spans named ``names``:
    inclusive (``total_s``) or self (``self_s``) seconds."""
    got = batch_spans(run)
    if got is None:
        return None
    from repro_torch import tracing

    requests, spans = got
    totals = tracing.summary(spans)
    return 1e3 * sum(totals[name][part] for name in names if name in totals) / requests
