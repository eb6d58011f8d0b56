"""kernel_roofline_pct (kernels K1-K6): the least time the traced window's
launches of the program's kernels could take on the H100 (``roofline``;
launches by shape class from ``kernels.ops.SHAPE_LAUNCHES``, N and n from
the cell) over the device time the profiler gave those kernels."""

from portbench.roofline import least_seconds


def read(run):
    tr = run.trace
    if tr is None:
        return None
    device_s = sum(tr.kernel_s.values())
    if device_s <= 0:
        return None
    least = sum(count * least_seconds(kernel, cls, N=run.n_rows, n=run.n_pivots)
                for kernel, by_cls in tr.launches.items() for cls, count in by_cls.items())
    return 100.0 * least / device_s
