"""The port's tracing and logging (``utils/trace.py``, ``utils/logger.py``)
against the JAX package's: the TTI trace's binary dump is byte for byte the
reference's, ``StageTimer`` pushes one entry, ``LayerLog`` writes what the
reference writes for the same calls, and the profiler wrapper
(``ProfilerTrace``, the counterpart of ``XlaTrace``) records an ``annotate``
span into a Chrome trace in its logdir with no error."""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from srsue_tpu.utils import logger as ref_logger
from srsue_tpu.utils import trace as ref_trace
from srsue_tpu_torch.utils import logger, trace

REPO = Path(__file__).resolve().parent.parent


def _filled(mod, n, capacity):
    t = mod.Trace(capacity=capacity)
    for i in range(n):
        t.push(1000 + 3 * i, 0.25 * i - 7.5)
    return t


@pytest.mark.parametrize("n", [0, 5, 21])  # empty, partly full, wrapped
def test_trace_dump_is_the_reference(tmp_path, n):
    _filled(trace, n, 16).dump(str(tmp_path / "mine.bin"))
    _filled(ref_trace, n, 16).dump(str(tmp_path / "ref.bin"))
    assert (tmp_path / "mine.bin").read_bytes() == (tmp_path / "ref.bin").read_bytes()
    tti, val = trace.Trace.load(str(tmp_path / "mine.bin"))
    k = min(n, 16)
    np.testing.assert_array_equal(tti, [1000 + 3 * i for i in range(n - k, n)])
    np.testing.assert_array_equal(val, np.float32([0.25 * i - 7.5 for i in range(n - k, n)]))


def test_trace_classes_are_the_reference():
    """Trace and StageTimer are the reference's classes, syntax tree for
    syntax tree (the rest of the module differs: the profiler)."""
    def classes(path):
        tree = ast.parse(path.read_text())
        return {n.name: ast.dump(n) for n in tree.body if isinstance(n, ast.ClassDef)}

    mine = classes(REPO / "srsue_tpu_torch" / "utils" / "trace.py")
    ref = classes(REPO / "srsue_tpu" / "utils" / "trace.py")
    for name in ("Trace", "StageTimer"):
        assert mine[name] == ref[name]


def test_stage_timer_pushes_one_entry():
    t = trace.Trace(capacity=8)
    t.enabled = False
    with trace.StageTimer(t, 7):
        pass
    assert t.n == 0
    t.enabled = True
    with trace.StageTimer(t, 7):
        sum(range(1000))
    assert t.n == 1 and t.tti[0] == 7 and t.val[0] > 0


def test_profiler_trace_records_the_span(tmp_path):
    logdir = tmp_path / "prof"
    with trace.ProfilerTrace(str(logdir)) as t:
        assert t.active
        with trace.annotate("srsue_span"):
            torch.ones(64).cumsum(0)
    assert t.errors == [] and not t.active
    assert Path(t.path).parent == logdir and os.listdir(logdir) == [Path(t.path).name]
    names = {e.get("name") for e in json.loads(Path(t.path).read_text())["traceEvents"]}
    assert "srsue_span" in names


def test_layer_log_is_the_reference(capsys):
    """The same calls write the same lines (the two packages' loggers share
    Python's logging namespace, so each takes its own layer name)."""
    outs = []
    for mod, layer in ((ref_logger, "obs_ref"), (logger, "obs_prt")):
        log = mod.get_logger(layer, level="info", hex_limit=4)
        mod.step_tti(1234)
        log.info("hello %d", 42)
        log.warning("pdu", hex=b"\x01\x02\x03\x04\x05")
        log.error("short", hex=b"\xff")
        log.debug("hidden")
        log.set_level("debug")
        mod.step_tti(7)
        log.debug("shown")
        outs.append(capsys.readouterr().err.replace(layer, "LAYER"))
    assert outs[0] == outs[1]
    assert "[ 1234]" in outs[1] and "hello 42" in outs[1] and "hidden" not in outs[1]
    assert "[5B: 01 02 03 04...]" in outs[1] and "[    7]" in outs[1]
