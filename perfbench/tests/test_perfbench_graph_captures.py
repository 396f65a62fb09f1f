"""The reader of ``graph_captures`` on a synthetic trace: captures counted a
step, 0 where the traced steps ran the turbo driver and captured nothing,
and nothing without a trace or where the steps hold neither span."""

import pytest

from perfbench import core, trace


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _run(events):
    """Two marked steps, 0-10 ms and 10-20 ms (the trace's clock is us)."""
    steps = [_x(trace.STEP, 0.0, 10_000.0), _x(trace.STEP, 10_000.0, 10_000.0)]
    return core.Run(trace=trace.records(steps + events))


@pytest.mark.parametrize("metric", ["graph_captures.tti", "graph_captures.p95"])
@pytest.mark.parametrize("events,value", [
    ([_x("turbo.graph_capture", 2_000.0, 500.0), _x("pdsch.turbo", 1_000.0, 3_000.0)], 0.5),
    ([_x("turbo.graph_capture", 2_000.0, 500.0), _x("turbo.graph_capture", 12_000.0, 500.0),
      _x("turbo.graph_capture", 13_000.0, 500.0)], 1.5),
    ([_x("pdsch.turbo", 1_000.0, 3_000.0), _x("turbo.iteration", 1_500.0, 100.0)], 0.0),
    ([_x("turbo.graph_capture", 2_000.0, 500.0, cat="cpu_op"),  # not a span
      _x("pdsch.turbo", 1_000.0, 3_000.0)], 0.0),
])
def test_reads_captures_a_step(metric, events, value):
    assert core.reader(metric).read(_run(events)) == pytest.approx(value)


def test_nothing_without_a_trace():
    assert core.reader("graph_captures.tti").read(core.Run()) is None


@pytest.mark.parametrize("events", [
    [],
    [_x("ue_dl.control", 1_000.0, 3_000.0), _x("turbo.iteration", 1_500.0, 100.0)],
    [_x("pdsch.turbo", 1_000.0, 3_000.0, cat="cpu_op")],  # not a span
])
def test_nothing_without_the_turbo_driver(events):
    assert core.reader("graph_captures.p95").read(_run(events)) is None
