"""The reader of ``frontend_replays`` on a synthetic trace: replays counted a
step, 0 where the traced steps ran a frontend and replayed nothing, and
nothing without a trace or where the steps hold no frontend span."""

import pytest

from perfbench import core, trace


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _run(events):
    """Two marked steps, 0-10 ms and 10-20 ms (the trace's clock is us)."""
    steps = [_x(trace.STEP, 0.0, 10_000.0), _x(trace.STEP, 10_000.0, 10_000.0)]
    return core.Run(trace=trace.records(steps + events))


@pytest.mark.parametrize("metric", ["frontend_replays.tti", "frontend_replays.ee",
                                    "frontend_replays.tput", "frontend_replays.p95"])
@pytest.mark.parametrize("events,value", [
    ([_x("ue_dl.frontend", 1_000.0, 900.0), _x("frontend.graph_replay", 1_100.0, 500.0),
      _x("ue_dl.frontend", 11_000.0, 900.0), _x("frontend.graph_replay", 11_100.0, 500.0)],
     1.0),
    ([_x("pdsch.frontend", 1_000.0, 900.0), _x("frontend.graph_replay", 1_100.0, 500.0),
      _x("pdsch.frontend", 11_000.0, 900.0), _x("frontend.graph_capture", 11_100.0, 500.0)],
     0.5),
    ([_x("ue_dl.frontend", 1_000.0, 900.0), _x("ue_dl.frontend", 11_000.0, 900.0)], 0.0),
    ([_x("pdsch.frontend", 1_000.0, 900.0)], 0.0),
    ([_x("frontend.graph_replay", 1_100.0, 500.0, cat="cpu_op"),  # not a span
      _x("pdsch.frontend", 1_000.0, 900.0)], 0.0),
])
def test_reads_replays_a_step(metric, events, value):
    assert core.reader(metric).read(_run(events)) == pytest.approx(value)


def test_nothing_without_a_trace():
    assert core.reader("frontend_replays.tti").read(core.Run()) is None


@pytest.mark.parametrize("events", [
    [],
    [_x("pusch.frontend", 1_000.0, 3_000.0), _x("turbo.iteration", 1_500.0, 100.0)],
    [_x("ue_dl.frontend", 1_000.0, 3_000.0, cat="cpu_op")],  # not a span
])
def test_nothing_without_a_frontend(events):
    assert core.reader("frontend_replays.p95").read(_run(events)) is None
