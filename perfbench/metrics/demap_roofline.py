"""The demap + descramble + dematch kernel's share of its roofline, %: the
least time of its work in the traced steps (``rooflines/demap.py``: each
symbol and its noise read once, each softbuffer value written once) over the
profiler's device time of the kernel's softbuffer form."""

from perfbench.rooflines import least_seconds


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_s(lambda name: "demap_dematch_tile" in name)
    if spent <= 0:
        return None
    return 100.0 * least_seconds(sum(w["demap_bytes"] for w in run.work), 0) / spent
