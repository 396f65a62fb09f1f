"""Host ms a step in the control layer: ``UeDl.process``'s ``ue_dl.control``
span, from the PCFICH decode and its CFI read through the blind search to
every batch element's hits (program span, profiler clock)."""

from perfbench import spans


def read(run):
    return spans.ms_per_step(run, "ue_dl.control")
