"""The turbo decode's share of its roofline, %: the least time of the work
these inputs need (``rooflines/turbo.py``) over the profiler's device time
of every BCJR kernel in the traced steps."""

from perfbench.rooflines import least_seconds


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_s(lambda name: "bcjr" in name)
    if spent <= 0:
        return None
    work = [w["turbo"] for w in run.work]
    least = least_seconds(sum(w["bytes"] for w in work), sum(w["ops"] for w in work))
    return 100.0 * least / spent
