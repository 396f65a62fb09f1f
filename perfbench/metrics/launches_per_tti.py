"""Device kernels, copies and sets per TTI in the traced window (profiler)."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    return run.trace.count() / run.trace.steps
