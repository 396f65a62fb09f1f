"""The device's idle share, %: 1 - the union of the kernels', copies' and
sets' intervals over the traced window's wall time (profiler)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
