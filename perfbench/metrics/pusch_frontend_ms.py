"""Host ms a step in the uplink's front end: ``PuschCodec.equalize_sf``'s
``pusch.frontend`` span, OFDM demodulation, the DMRS estimate, ZF and the
IDFT that undoes the precoding (program span, profiler clock)."""

from perfbench import spans


def read(run):
    return spans.ms_per_step(run, "pusch.frontend")
