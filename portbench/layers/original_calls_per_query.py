"""original_calls_per_query (metrics.supermetrics): true-metric evaluations
per answered request, pivot distances included, from each answer's
``QueryResult.stats.original_calls``."""


def read(run):
    win = run.window
    calls = [win.kept[i][0] for i in range(win.issued) if win.ok[i]]
    return sum(calls) / len(calls) if calls else None
