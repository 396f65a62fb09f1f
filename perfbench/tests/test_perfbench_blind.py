"""The blind chain's cell ``tm1_b256_blind_forced8`` on the CPU at 6 PRB, past
the harness's look for a card: ``rx.make_rx``'s outputs equal the plain
reference's (bits, flags, iterations, CFI, DCI hit, softbuffers); an altered
decision is not correct; the bf16 control is not correct; the reference finds
every subframe's CFI and DCI."""

import time

import numpy as np
import pytest
import torch

from perfbench import control, core, inputs
from perfbench.reference import blind, receiver

CELL = "tm1_b256_blind_forced8"
SMALL = {"n_prb": 6, "cfi": 3, "mcs": 20}
SHRINK = {"batch": 4, "n_batches": 2, "sample": {"steps": 2, "rows": 2}}


def measure(hooks=None, seed=2**31 + 43):
    return core.measure(CELL, seed, 0.5, False, time.perf_counter(), device="cpu",
                        hooks=hooks, cfg_over=SMALL, wl_over=SHRINK)


def test_port_equals_reference():
    out = measure()
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    wrong = {k: v["value"] for k, v in out["compared"].items() if k.endswith("_wrong")}
    assert set(wrong) == {"payload_bits_wrong", "tb_flags_wrong", "iters_wrong", "cfi_wrong",
                          "dci_wrong"} and not any(wrong.values())
    assert out["compared"]["softbuf_rel_err"]["value"] < 1e-5
    assert set(out["metrics"]) == {"batch_p95_ms", "decoded_mbps", "setup_s"}


def _altered(field):
    def hook(runner):
        step = runner.step

        def broken(i):
            out = step(i)
            value = np.array(getattr(out, field), copy=True)
            if value.dtype == bool:
                value ^= True
            elif field == "cfi":
                value += 1
            else:
                value[..., 0] ^= 1
            setattr(out, field, value)
            return out

        runner.step = broken
        return runner
    return hook


@pytest.mark.parametrize("field,number", [("payload", "payload_bits_wrong"),
                                          ("cfi", "cfi_wrong"), ("dci_hit", "dci_wrong")])
def test_altered_answer_is_not_correct(field, number):
    out = measure(hooks=_altered(field))
    assert not out["correct"]
    assert out["compared"][number]["value"] > 0


def test_control_is_not_correct():
    r = control.readings(CELL, 2**32 + 9, "cpu", cfg_over=SMALL, wl_over=SHRINK)
    assert not r["correct"], r
    assert r["numbers"]["softbuf_rel_err"] > 1e-4


def test_reference_finds_every_cfi_and_dci():
    cfg = {**core.load_json("configs", "lte20_tm1_mcs28"), **SMALL}
    clean, iq = inputs.noisy_batches(cfg, 2**31 + 11, 3, 1, "cpu")
    out = blind.decode(receiver.Receiver(cfg), iq[0].numpy())
    assert (out.cfi == 3).all() and out.hits.tolist() == [True] * 3
    assert (out.payload == clean.payloads).all() and out.tb_ok.all() and (out.iters == 8).all()


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = core.measure(CELL, 2**31 + 37, 2.0, False, time.perf_counter())
    assert out["correct"], out["compared"]
