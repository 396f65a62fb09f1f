"""Replays of a receive frontend's CUDA graph a step:
``frontend.graph_replay`` spans counted (program counter, profiler trace).
It reads 0 where the traced steps ran a frontend (``ue_dl.frontend`` or
``pdsch.frontend`` spans) and replayed no graph, as a program without the
frontend's graphs does, and nothing where they hold none of these spans."""

from perfbench import spans


def read(run):
    replays = spans.count_per_step(run, "frontend.graph_replay")
    if replays is not None:
        return replays
    ran = any(spans.count_per_step(run, name) is not None
              for name in ("ue_dl.frontend", "pdsch.frontend"))
    return 0.0 if ran else None
