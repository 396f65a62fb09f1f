"""Host ms a step in the uplink's turbo driver: ``PuschCodec.decode_softbuffers``'
``pusch.turbo`` span, each K-group's stack of its blocks' softbuffers and
its ``turbo.decode`` with the early exit's reads (program span, profiler
clock)."""

from perfbench import spans


def read(run):
    return spans.ms_per_step(run, "pusch.turbo")
