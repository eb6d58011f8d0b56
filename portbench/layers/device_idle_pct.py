"""device_idle_pct (device): share of the traced window in which no kernel,
copy or set ran on the card (``torch.profiler``, CUPTI)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
