"""Each cell's run on the CPU at 6 PRB, past the harness's look for a card:
the port's entries equal the reference; with the timed path broken
underneath, ``correct`` comes out false; the bf16 control is not correct."""

import time

import numpy as np
import pytest

from perfbench import control, core

SMALL = {"n_prb": 6, "cfi": 3, "mcs": 20}
SHRINK = {"tm1_b256_forced8": {"batch": 4, "n_batches": 2, "sample": {"steps": 2, "rows": 2}},
          "tm2_b256_ue_dl": {"batch": 4, "n_batches": 2, "sample": {"steps": 2, "rows": 2}},
          "tm1_b1_ue_tti": {"pool": 3, "warm_steps": 1, "sample": {"steps": 2, "rows": 1}},
          "tm1_4card_b256_forced8": {"batch": 8, "ranks": 2, "sample": {"steps": 1, "rows": 1}}}
ONE_PROCESS = ["tm1_b256_forced8", "tm2_b256_ue_dl", "tm1_b1_ue_tti"]


def measure(cell, seed=2**31 + 17, hooks=None, seconds=0.5):
    return core.measure(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                        hooks=hooks, cfg_over=SMALL, wl_over=SHRINK[cell])


def flip_payload_bit(runner):
    """Alter the first decoded bit of every subframe where it is produced."""
    step = runner.step

    def broken(i):
        out = step(i)
        res = getattr(out, "res", out)
        res.payload = np.array(res.payload, copy=True)
        res.payload[..., 0] ^= 1
        return out

    runner.step = broken
    return runner


@pytest.mark.parametrize("cell", ONE_PROCESS)
def test_port_equals_reference(cell):
    out = measure(cell)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(v["value"] == 0 for k, v in out["compared"].items() if k.endswith("_wrong"))
    assert set(out["metrics"]) >= {"setup_s"}
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("cell", ONE_PROCESS)
def test_altered_answer_is_not_correct(cell):
    out = measure(cell, hooks=flip_payload_bit)
    assert not out["correct"]
    assert out["compared"]["payload_bits_wrong"]["value"] > 0


def test_sharded_cell_equals_reference():
    out = measure("tm1_4card_b256_forced8", seconds=1.0)
    assert out["correct"], out["compared"]
    assert out["device"]["count"] == 4


def test_sharded_cell_without_the_exchange_fails():
    """With the all_reduce between the ranks left out the run is not
    correct: the port's own check raises, or the global SNR is wrong."""
    def no_exchange(runner):
        runner.fault = "no_exchange"
        return runner

    try:
        out = measure("tm1_4card_b256_forced8", hooks=no_exchange, seconds=1.0)
    except RuntimeError as e:
        assert "uneven carrier shards" in str(e)
    else:
        assert not out["correct"]


@pytest.mark.parametrize("cell", ONE_PROCESS + ["tm1_4card_b256_forced8"])
def test_control_is_not_correct(cell):
    r = control.readings(cell, 2**32 + 3, "cpu", cfg_over=SMALL, wl_over=SHRINK[cell])
    assert not r["correct"], r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_PROCESS)
def test_cell_on_the_card(cell):
    """One short run of the cell at its own size on the card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = core.measure(cell, 2**31 + 23, 2.0, False, time.perf_counter())
    assert out["correct"], out["compared"]
