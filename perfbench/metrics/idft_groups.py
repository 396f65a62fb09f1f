"""The uplink front end's IDFTs a step: ``pusch.idft_group`` spans counted,
one an IDFT over the allocations of one size of every subframe (program
counter, profiler trace)."""

from perfbench import spans


def read(run):
    return spans.count_per_step(run, "pusch.idft_group")
