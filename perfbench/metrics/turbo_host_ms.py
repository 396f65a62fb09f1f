"""Host ms a step in the turbo driver: the ``pdsch.turbo`` span of
``PdschCodec.decode_blocks``, every K-group's iteration loop with its
early-exit reads (program span, profiler clock)."""

from perfbench import spans


def read(run):
    return spans.ms_per_step(run, "pdsch.turbo")
