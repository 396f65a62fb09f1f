"""The harness: one cell, one seed, one run.

Everything a cell is made of is found by its name: the cell in
``workloads/<cell>.json``, its configuration in ``configs/<config>.json``,
the code that builds the port's callable and its step in
``entries/<entry>.py``, every metric's reader in ``metrics/<name>.py`` by
the part of its name before the first dot, and the metrics each cell
reports in ``BENCHMARK.json``. ``measure`` runs the
closed loop: set-up and warm-up, a window of ``seconds`` in which one step is
in flight at a time, and after it the comparison with the plain reference.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "srsue_tpu")  # by whole top-level name


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """perfbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench.{kind}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The reader of a metric: ``metrics/<name>.py`` by the part of the
    metric's name before its first dot, so that one reader serves the
    metric in every cell (``idle_share.tput``, ``idle_share.tti``)."""
    return load_module("metrics", metric.split(".")[0])


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def metrics_of(cell: str, group: str, bench: dict | None = None) -> list[dict]:
    """The metrics of ``BENCHMARK.json``'s `group` that `cell` reports."""
    bench = bench or benchmark()
    return [m for m in bench[group] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of `k` of a stream of steps (reservoir sampling),
    drawn from `rng`: ``offer`` keeps ``make()`` of the steps it chooses."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = make()


@dataclasses.dataclass
class Run:
    """What one run recorded, for the metric readers."""

    setup_s: float = 0.0
    window_s: float = 0.0
    step_s: list = dataclasses.field(default_factory=list)  # each step's latency
    bits: int = 0              # transport-block bits decoded and passed
    attempted: int = 0         # transport blocks attempted
    failed: int = 0            # transport blocks whose CRC failed
    spans: dict = dataclasses.field(default_factory=dict)   # name -> ms per step
    work: list = dataclasses.field(default_factory=list)    # per traced step
    trace: object = None       # trace.Records of the traced steps, or None
    memory_peak_bytes: int = 0
    busy_s: float | None = None  # device busy seconds averaged over the ranks


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def mbps(run: Run) -> float:
    """Transport-block Mbit/s whose CRC passed, over the window's wall time."""
    return run.bits / run.window_s / 1e6


def step_p95_ms(run: Run) -> float:
    """95th percentile of the step latency over every step of the window,
    from the call until the step's outputs are on the host (host clock)."""
    return 1e3 * percentile(run.step_s, 95)


def window(run: Run, runner, seconds: float, trace_s: float | None, rng) -> Reservoir:
    """The measured closed loop: steps until `seconds` have passed, one in
    flight at a time. A step's latency runs from its call until its outputs
    are on the host. With `trace_s`, the profiler records the steps of the
    last `trace_s` seconds (at least that long, should starting it take
    time). Returns the sample of steps kept for the comparison."""
    from . import trace as tracing

    keep = Reservoir(runner.sample_steps, rng)
    if trace_s is not None:  # the profiler's first start initialises CUPTI: not in the window
        tracing.stop(tracing.start())
    prof = t_prof = None
    t_start = time.perf_counter()
    t_end = t_start + seconds
    t_trace = None if trace_s is None else t_end - min(trace_s, seconds)
    i = 0
    while True:
        if t_trace is not None and prof is None and time.perf_counter() >= t_trace:
            prof, t_prof = tracing.start(), time.perf_counter()
        t0 = time.perf_counter()
        if prof is not None:
            with tracing.step():
                out = runner.step(i)
            run.work.append(runner.work(out))
        else:
            out = runner.step(i)
        t1 = time.perf_counter()
        run.step_s.append(t1 - t0)
        n_ok = runner.n_ok(out)
        run.attempted += runner.batch
        run.failed += runner.batch - n_ok
        run.bits += n_ok * runner.tbs
        keep.offer(lambda: (i, out))
        i += 1
        if t1 >= t_end and (prof is None or t1 - t_prof >= min(trace_s, seconds)):
            break
    run.window_s = t1 - t_start
    if prof is not None:
        run.trace = tracing.finish(prof)
    return keep


def measure(cell: str, seed: int, seconds: float, trace: bool, t_process: float,
            device: str = "cuda", hooks=None, cfg_over: dict | None = None,
            wl_over: dict | None = None) -> dict:
    """One run of `cell`; returns the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device`` and, traced,
    ``breakdown``) and the numbers compared under ``compared``. The tests
    run it on the CPU, with `hooks` to wrap the runner and `cfg_over` and
    `wl_over` to shrink the configuration and the cell."""
    import torch

    from . import judge
    from . import trace as tracing

    wl = {**load_json("workloads", cell), **(wl_over or {})}
    cfg = {**load_json("configs", wl["config"]), **(cfg_over or {})}
    entry = load_module("entries", wl["entry"])
    run = Run()
    rng = np.random.default_rng([seed, 1])  # the sample; the inputs draw from seed itself
    runner = entry.build(cfg, wl, seed, device, trace)
    if hooks is not None:
        runner = hooks(runner)
    runner.warm()
    run.setup_s = time.perf_counter() - t_process
    trace_s = tracing.SECONDS if trace else None
    if hasattr(runner, "window"):  # a window that runs inside spawned ranks
        kept = runner.window(run, seconds, trace_s, t_process)
    else:
        kept = window(run, runner, seconds, trace_s, rng).items
    run.spans = runner.spans()
    run.memory_peak_bytes = runner.memory_peak()
    t_judge = time.perf_counter()
    numbers = runner.judge(kept, rng)  # frees the program's state first
    t_judge = time.perf_counter() - t_judge
    del kept
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(cell, group):
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": judge.correct(numbers, wl["limits"]), "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s if run.busy_s is None else run.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["info"] = {"steps": len(run.step_s), "median_step_ms": 1e3 * percentile(run.step_s, 50),
                   "window_s": run.window_s, "setup_s": run.setup_s,
                   "sample_steps": runner.sample_steps, "judge_s": t_judge}
    out["compared"] = judge.table(numbers, wl["limits"])
    return out
