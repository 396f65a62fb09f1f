"""Replays of the uplink receive's CUDA graphs a step:
``frontend.graph_replay`` spans counted (program counter, profiler trace),
two a step where the front end and the demap both replay. It reads 0 where
the traced steps ran the uplink's front end (``pusch.frontend`` spans) and
replayed no graph, as a program without the uplink's graphs does, and
nothing where they hold neither span."""

from perfbench import spans


def read(run):
    replays = spans.count_per_step(run, "frontend.graph_replay")
    if replays is not None:
        return replays
    return 0.0 if spans.count_per_step(run, "pusch.frontend") is not None else None
