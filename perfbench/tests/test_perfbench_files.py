"""Every piece BENCHMARK.json names is found by its name, and holds what the
harness reads."""

import json

import pytest

from perfbench import core

BENCH = core.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_workload_loads(cell):
    wl = core.load_json("workloads", cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert wl["config"] == entry["config"]
    assert wl["chips"] == entry["chips"]
    assert hasattr(core.load_module("entries", wl["entry"]), "build")
    assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())
    assert core.metrics_of(cell, "end_to_end", BENCH), "every cell reports end-to-end metrics"
    assert core.metrics_of(cell, "per_layer", BENCH), "every cell reports per-layer metrics"


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_loads(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((core.ROOT / entry["file"]).read_text())
    assert cfg == core.load_json("configs", config)
    assert cfg["reduced"] == entry["reduced"]
    for key in ("n_prb", "cell_id", "n_ports", "subframe", "cfi", "rnti", "mcs",
                "turbo_iters", "snr_db"):
        assert key in cfg


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_loads(metric):
    assert callable(core.reader(metric).read)


def test_names_and_sizes():
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    names = CELLS + METRICS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert len((core.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
