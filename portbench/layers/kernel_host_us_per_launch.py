"""kernel_host_us_per_launch (kernels K1-K6): mean host microseconds of
one call of a kernel's wrapper, checks, allocation and launch included
(the program's ``kernel.K1`` ... ``kernel.K6`` spans); set against the
trace's device time per launch in PERF.md."""

from portbench.layers._spans import batch_spans


def read(run):
    got = batch_spans(run)
    if got is None:
        return None
    calls = [s.seconds for s in got[1] if s.name.startswith("kernel.")]
    return 1e6 * sum(calls) / len(calls) if calls else None
