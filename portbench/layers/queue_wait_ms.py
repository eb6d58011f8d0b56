"""queue_wait_ms (launch.service): mean wait of a request in the service's
queue, from ``submit`` to the moment the dispatcher took its batch (the
program's ``service.queue`` spans)."""

from portbench.layers._spans import batch_spans


def read(run):
    got = batch_spans(run)
    if got is None:
        return None
    waits = [s.seconds for s in got[1] if s.name == "service.queue"]
    return 1e3 * sum(waits) / len(waits) if waits else None
