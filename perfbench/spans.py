"""The program's own spans in a traced run: the host events of category
``user_annotation`` that ``srsue_tpu_torch.utils.trace.annotate`` records on
the profiler's clock, within the traced window (``trace.Records.host``).
Both readers return None where the trace holds no such span, as a program
without it gives."""

from __future__ import annotations


def _events(run, name: str) -> list:
    if run.trace is None or not run.trace.steps:
        return []
    return [e for e in run.trace.host if e.cat == "user_annotation" and e.name == name]


def ms_per_step(run, name: str) -> float | None:
    """Host ms a step inside the span `name`, its intervals clipped to the
    traced window."""
    events = _events(run, name)
    if not events:
        return None
    t0, t1 = run.trace.t0, run.trace.t1
    inside = sum(min(e.ts + e.dur, t1) - max(e.ts, t0) for e in events)
    return 1e-3 * inside / run.trace.steps


def count_per_step(run, name: str) -> float | None:
    """The span `name`'s occurrences a step."""
    events = _events(run, name)
    return len(events) / run.trace.steps if events else None
