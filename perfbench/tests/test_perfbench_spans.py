"""The readers of the program's spans (``perfbench/spans.py``) on a synthetic
trace: host ms a step inside a span, clipped to the traced window, spans
counted a step, and None where the trace holds no such span."""

import pytest

from perfbench import core, spans, trace


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _run(events):
    """Two marked steps, 0-10 ms and 10-20 ms (the trace's clock is us)."""
    steps = [_x(trace.STEP, 0.0, 10_000.0), _x(trace.STEP, 10_000.0, 10_000.0)]
    return core.Run(trace=trace.records(steps + events))


def test_ms_and_count_per_step():
    run = _run([_x("ue_dl.control", 1_000.0, 2_000.0), _x("ue_dl.control", 11_000.0, 4_000.0),
                _x("turbo.exit_check", 5_000.0, 10.0), _x("turbo.exit_check", 6_000.0, 10.0),
                _x("turbo.exit_check", 16_000.0, 10.0),
                _x("ue_dl.control", 12_000.0, 500.0, cat="cpu_op")])  # not a span
    assert spans.ms_per_step(run, "ue_dl.control") == pytest.approx(3.0)
    assert spans.count_per_step(run, "ue_dl.control") == 1.0
    assert spans.count_per_step(run, "turbo.exit_check") == 1.5


def test_span_clipped_to_the_window():
    run = _run([_x("shard.exchange", -3_000.0, 5_000.0), _x("shard.exchange", 19_000.0, 4_000.0)])
    assert spans.ms_per_step(run, "shard.exchange") == pytest.approx(1.5)


@pytest.mark.parametrize("read", [spans.ms_per_step, spans.count_per_step])
def test_none_without_the_span(read):
    assert read(_run([_x("aten::mul", 1_000.0, 5.0, cat="cpu_op")]), "ue_dl.control") is None
    assert read(core.Run(), "ue_dl.control") is None


@pytest.mark.parametrize("metric,span,value", [
    ("control_ms.tti", "ue_dl.control", 1.0), ("turbo_host_ms.p95", "pdsch.turbo", 1.0),
    ("exit_checks.tti", "turbo.exit_check", 0.5), ("exchange_ms.shard", "shard.exchange", 1.0)])
def test_reader_reads_its_span(metric, span, value):
    run = _run([_x(span, 2_000.0, 2_000.0)])
    assert core.reader(metric).read(run) == pytest.approx(value)
    other = _run([_x("ue_dl.frontend", 2_000.0, 2_000.0)])
    assert core.reader(metric).read(other) is None
