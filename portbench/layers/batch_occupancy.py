"""batch_occupancy (launch.service): real requests per batch the service
dispatched in the window, from the counters of ``SearchService.stats()``
(padding rows are not requests, so they are not counted)."""


def read(run):
    n = run.service["n_batches"]
    return run.service["n_requests"] / n if n else None
