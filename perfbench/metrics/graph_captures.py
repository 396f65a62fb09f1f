"""Captures of the turbo driver's loop as CUDA graphs a step:
``turbo.graph_capture`` spans counted (program counter, profiler trace). It
reads 0 where the traced steps ran the turbo driver (``pdsch.turbo`` spans)
and captured nothing, as every step that replays graphs captured during the
warm-up does, and nothing where they hold neither span."""

from perfbench import spans


def read(run):
    captures = spans.count_per_step(run, "turbo.graph_capture")
    if captures is not None:
        return captures
    return 0.0 if spans.count_per_step(run, "pdsch.turbo") is not None else None
