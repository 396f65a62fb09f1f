"""Rank 0's NCCL kernel device ms per step, its wait for the slowest rank
included (profiler)."""


def read(run):
    if run.trace is None or not run.trace.steps:
        return None
    spent = run.trace.kernel_s(lambda name: "nccl" in name.lower())
    return 1e3 * spent / run.trace.steps if spent > 0 else None
