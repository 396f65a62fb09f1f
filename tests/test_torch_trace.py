"""The port's tracing and logging (``utils/trace.py``, ``utils/logger.py``)
against the JAX package's: ``LayerLog`` writes what the reference writes for
the same calls, and the profiler wrapper (``ProfilerTrace``, the counterpart
of ``XlaTrace``) records an ``annotate`` span into a Chrome trace in its
logdir with no error. The spans themselves: ``tests/test_torch_spans.py``."""

import json
import os
from pathlib import Path

import torch

from srsue_tpu.utils import logger as ref_logger
from srsue_tpu_torch.utils import logger, trace


def test_profiler_trace_records_the_span(tmp_path):
    logdir = tmp_path / "prof"
    with trace.ProfilerTrace(str(logdir)) as t:
        assert t.active
        with trace.annotate("ue_dl.process"):
            torch.ones(64).cumsum(0)
    assert t.errors == [] and not t.active
    assert Path(t.path).parent == logdir and os.listdir(logdir) == [Path(t.path).name]
    names = {e.get("name") for e in json.loads(Path(t.path).read_text())["traceEvents"]}
    assert "ue_dl.process" in names


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
