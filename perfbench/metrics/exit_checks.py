"""The turbo early exit's host synchronisations a step: ``turbo.exit_check``
spans counted (program counter, profiler trace)."""

from perfbench import spans


def read(run):
    return spans.count_per_step(run, "turbo.exit_check")
