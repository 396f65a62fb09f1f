"""Per-TTI trace ring buffer with binary dump, a stage timer, and the
device profiler: counterpart of ``srsue_tpu/utils/trace.py``.

``Trace`` and ``StageTimer`` are the reference's host code, unchanged (the
dump is byte-identical). ``ProfilerTrace`` stands in for the reference's
``XlaTrace`` (jax.profiler) with the same contract: ``logdir``, ``active``,
an ``errors`` list, and a trace written into ``logdir``; here a Chrome trace
by ``torch.profiler``, which records the CUDA kernels when a GPU is present.
``annotate`` is ``torch.profiler.record_function``.
"""

from __future__ import annotations

import os
import struct
import time

import numpy as np
import torch


class Trace:
    def __init__(self, capacity: int = 1 << 14):
        self.tti = np.zeros(capacity, np.uint32)
        self.val = np.zeros(capacity, np.float32)
        self.n = 0
        self.capacity = capacity
        self.enabled = True

    def push(self, tti: int, value: float) -> None:
        if not self.enabled:
            return
        i = self.n % self.capacity
        self.tti[i] = tti
        self.val[i] = value
        self.n += 1

    def dump(self, path: str) -> None:
        """Binary dump: uint32 count, then (uint32 tti, float32 value)*."""
        k = min(self.n, self.capacity)
        with open(path, "wb") as f:
            f.write(struct.pack("<I", k))
            order = np.arange(self.n - k, self.n) % self.capacity
            rec = np.empty((k, 2), np.uint32)
            rec[:, 0] = self.tti[order]
            rec[:, 1] = self.val[order].view(np.uint32)
            f.write(rec.tobytes())

    @staticmethod
    def load(path: str):
        with open(path, "rb") as f:
            (k,) = struct.unpack("<I", f.read(4))
            rec = np.frombuffer(f.read(8 * k), np.uint32).reshape(k, 2)
        return rec[:, 0].copy(), rec[:, 1].copy().view(np.float32)


class StageTimer:
    """with StageTimer(trace, tti): ... — wall-clock stage timing in us
    (the tr_log_start/tr_log_end pattern)."""

    def __init__(self, trace: Trace, tti: int):
        self.trace = trace
        self.tti = tti

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.trace.push(self.tti, (time.perf_counter() - self.t0) * 1e6)
        return False


class ProfilerTrace:
    """Device-level profiling by ``torch.profiler`` (CPU ops, and CUDA
    kernels when a GPU is present): the counterpart of the reference's
    ``XlaTrace``.

    with ProfilerTrace("/tmp/prof") as t: run_things()
    # t.path: the Chrome trace written into logdir

    A profiler that cannot start or stop leaves its message in `errors`
    instead of raising, as ``XlaTrace`` does.
    """

    def __init__(self, logdir: str):
        self.logdir = logdir
        self.active = False
        self.errors: list[str] = []
        self.path: str | None = None
        self._prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self.active = True
        except RuntimeError as e:  # profiler unsupported on this runtime
            self.errors.append(f"torch profiler unavailable: {e}")
        return self

    def __exit__(self, *exc):
        if self.active:
            try:
                self._prof.__exit__(None, None, None)
                os.makedirs(self.logdir, exist_ok=True)
                self.path = os.path.join(self.logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
                self._prof.export_chrome_trace(self.path)
            except (RuntimeError, OSError) as e:
                self.errors.append(f"torch profiler stop failed: {e}")
            self.active = False
        return False


def annotate(name: str):
    """Named host span in the profiler's timeline
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
