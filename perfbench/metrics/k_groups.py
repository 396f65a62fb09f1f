"""The uplink's turbo decodes a step: ``pusch.k_group`` spans counted, one a
``turbo.decode`` call over the code blocks of one K of every UE of the
subframe (program counter, profiler trace)."""

from perfbench import spans


def read(run):
    return spans.count_per_step(run, "pusch.k_group")
