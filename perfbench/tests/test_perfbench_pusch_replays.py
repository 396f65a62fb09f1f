"""The reader of ``pusch_replays`` on a synthetic trace: the uplink's graph
replays counted a step, 0 where the traced steps ran its front end and
replayed nothing, and nothing without a trace or where the steps hold
neither span."""

import pytest

from perfbench import core, trace


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _run(events):
    """Two marked steps, 0-10 ms and 10-20 ms (the trace's clock is us)."""
    steps = [_x(trace.STEP, 0.0, 10_000.0), _x(trace.STEP, 10_000.0, 10_000.0)]
    return core.Run(trace=trace.records(steps + events))


def _step(t0, stage_events):
    """One step's uplink front end and demap from t0 (us), each holding the
    given graph spans."""
    out = []
    for i, (stage, inner) in enumerate((("pusch.frontend", stage_events),
                                        ("pusch.demap_dematch", stage_events))):
        start = t0 + 1_000.0 * (1 + 2 * i)
        out.append(_x(stage, start, 900.0))
        out += [_x(name, start + 100.0 * (1 + j), 50.0) for j, name in enumerate(inner)]
    return out


@pytest.mark.parametrize("metric", ["pusch_replays.ul", "pusch_replays.mu"])
@pytest.mark.parametrize("events,value", [
    (_step(0.0, ["frontend.graph_replay"]) + _step(10_000.0, ["frontend.graph_replay"]), 2.0),
    (_step(0.0, ["frontend.graph_capture", "frontend.graph_replay"])
     + _step(10_000.0, ["frontend.graph_replay"]), 2.0),
    (_step(0.0, []) + _step(10_000.0, ["frontend.graph_replay"]), 1.0),
    (_step(0.0, []) + _step(10_000.0, []), 0.0),
    ([_x("pusch.frontend", 1_000.0, 900.0)], 0.0),
    ([_x("frontend.graph_replay", 1_100.0, 50.0, cat="cpu_op"),  # not a span
      _x("pusch.frontend", 1_000.0, 900.0)], 0.0),
])
def test_reads_replays_a_step(metric, events, value):
    assert core.reader(metric).read(_run(events)) == pytest.approx(value)


def test_nothing_without_a_trace():
    assert core.reader("pusch_replays.mu").read(core.Run()) is None


@pytest.mark.parametrize("events", [
    [],
    [_x("pusch.turbo", 1_000.0, 3_000.0), _x("turbo.iteration", 1_500.0, 100.0)],
    [_x("pusch.frontend", 1_000.0, 3_000.0, cat="cpu_op")],  # not a span
])
def test_nothing_without_the_uplink_front_end(events):
    assert core.reader("pusch_replays.ul").read(_run(events)) is None
