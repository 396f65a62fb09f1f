"""Host ms a step in the uplink's UCI decode: the ``pusch.uci`` span of
``PuschCodec.decode_uci_sf``, the launches of each subframe's CQI
correlation and ACK sign; the host's read of them follows the span
(program span, profiler clock)."""

from perfbench import spans


def read(run):
    return spans.ms_per_step(run, "pusch.uci")
