"""The device trace of a run's last steps, by ``torch.profiler``.

``start`` begins a profile of the host and the card, ``step`` marks one
step, ``finish`` stops and reads the profiler's Chrome trace into
``Records``: the kernels, copies and sets that ran on the device, the CUDA
runtime calls and the host's operators, in the trace's one clock (us). The
traced window runs from the first marked step's start to the last one's end.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from pathlib import Path

SECONDS = 2.0  # the traced stretch at the window's end
STEP = "perfbench.step"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
SCAN = 500  # host events before a gap's midpoint searched for the one spanning it


def start():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)
    prof.start()
    return prof


def stop(prof) -> None:
    """Stop a profile and drop what it recorded."""
    prof.stop()


def step():
    import torch

    return torch.profiler.record_function(STEP)


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    ts: float   # us
    dur: float  # us


@dataclasses.dataclass
class Records:
    """The traced window's events and what they add up to."""

    device: list        # Event of every kernel, copy and set in the window
    host: list          # Event of every host operator and runtime call
    steps: int          # steps marked in the window
    t0: float           # window start (us)
    t1: float           # window end (us)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device events' intervals, clipped to the window."""
        spans = sorted((max(e.ts, self.t0), min(e.ts + e.dur, self.t1)) for e in self.device)
        merged = []
        for a, b in spans:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name `match` accepts."""
        return sum(e.dur for e in self.device if e.cat == "kernel" and match(e.name)) * 1e-6

    def count(self) -> int:
        """Kernels, copies and sets."""
        return len(self.device)

    def syncs(self) -> int:
        """Host calls that wait for the device."""
        return sum(1 for e in self.host if e.cat == "cuda_runtime" and e.name in SYNCS)

    def gaps(self) -> list:
        """(start, end) us of the device's idle stretches in the window."""
        out, t = [], self.t0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing: the innermost host event spanning each
        gap's midpoint (``host`` where none did)."""
        by_op: dict = {}
        for e in self.device:
            by_op[e.name[:160]] = by_op.get(e.name[:160], 0.0) + e.dur * 1e-6
        hosts = sorted(self.host, key=lambda e: e.ts)
        starts = [e.ts for e in hosts]
        by_host: dict = {}
        for a, b in self.gaps():
            mid = 0.5 * (a + b)
            j = bisect.bisect_right(starts, mid)
            inner = [e for e in hosts[max(0, j - SCAN):j] if mid <= e.ts + e.dur]
            name = min(inner, key=lambda e: e.dur).name[:160] if inner else "host"
            by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-6
        rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}


def finish(prof) -> Records:
    """Stop the profiler and read its trace (written to, and removed from, a
    temporary directory)."""
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    tmp = Path(tempfile.mkdtemp(prefix="perfbench_trace_"))
    path = tmp / "trace.json"
    try:
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        path.unlink(missing_ok=True)
        os.rmdir(tmp)
    return records(events)


def records(events: list) -> Records:
    """Records of a Chrome trace's complete events."""
    dev, host, steps = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ev = Event(e.get("name", ""), e.get("cat", ""), float(e["ts"]), float(e.get("dur", 0)))
        if ev.cat in DEVICE_CATS:
            dev.append(ev)
        elif ev.cat in HOST_CATS:
            (steps if ev.name == STEP and ev.cat == "user_annotation" else host).append(ev)
    if not steps:
        raise RuntimeError("the trace holds no marked step")
    t0 = min(s.ts for s in steps)
    t1 = max(s.ts + s.dur for s in steps)
    inside = [e for e in dev if e.ts < t1 and e.ts + e.dur > t0]
    return Records(inside, [e for e in host if e.ts < t1 and e.ts + e.dur > t0], len(steps),
                   t0, t1)
