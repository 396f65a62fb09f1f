"""The uplink cell ``pusch_enb_b256`` on the CPU at 6 PRB (I_TBS 19: one block
of K=2624), its plain reference alone, its bf16 control, the readers of its
spans and its counts; and ``tm1_b256_early_exit`` shrunk, past the
harness's look for a card."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import core, spans, trace
from perfbench.reference import transmitter, uplink
from perfbench.reference.lte import ra, segmentation
from perfbench.rooflines import demap

SMALL = {"n_prb": 6, "tbs": 2600, "code_blocks": 1, "block_k": 2624}
SHRINK = {"batch": 4, "n_batches": 2, "sample": {"steps": 2, "rows": 2}}
CFG = {**core.load_json("configs", "lte20_pusch_mcs20_uci"), **SMALL}


def measure(cell="pusch_enb_b256", hooks=None, seed=2**31 + 19, cfg_over=SMALL):
    return core.measure(cell, seed, 0.5, False, time.perf_counter(), device="cpu",
                        hooks=hooks, cfg_over=cfg_over, wl_over=SHRINK)


def test_port_equals_reference():
    out = measure()
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    wrong = {k: v["value"] for k, v in out["compared"].items() if k.endswith("_wrong")}
    assert set(wrong) == {"payload_bits_wrong", "tb_flags_wrong", "iters_wrong", "cqi_wrong",
                          "ack_wrong"} and not any(wrong.values())
    assert out["compared"]["softbuf_rel_err"]["value"] < 1e-5
    assert set(out["metrics"]) == {"batch_p95_ms", "decoded_mbps", "setup_s"}


def _altered(field):
    """A hook that flips `field`'s first decision in every subframe."""
    def hook(runner):
        step = runner.step

        def broken(i):
            out = step(i)
            value = np.array(getattr(out, field), copy=True)
            if value.dtype == bool:
                value ^= True
            else:
                value[..., 0] ^= 1
            setattr(out, field, value)
            return out

        runner.step = broken
        return runner
    return hook


@pytest.mark.parametrize("field,number", [("payload", "payload_bits_wrong"),
                                          ("cqi", "cqi_wrong"), ("ack", "ack_wrong")])
def test_altered_answer_is_not_correct(field, number):
    out = measure(hooks=_altered(field))
    assert not out["correct"]
    assert out["compared"][number]["value"] > 0


def test_control_is_not_correct():
    r = core.load_module("entries", "pusch").readings(
        "pusch_enb_b256", 2**32 + 5, "cpu", cfg_over=SMALL, wl_over=SHRINK)
    assert not r["correct"], r
    assert r["numbers"]["softbuf_rel_err"] > 1e-4


def test_early_exit_cell_equals_reference():
    out = measure("tm1_b256_early_exit", cfg_over={"n_prb": 6, "cfi": 3, "mcs": 20})
    assert out["correct"], out["compared"]
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"batch_p95_ms", "decoded_mbps", "setup_s"}


@pytest.mark.parametrize("ack_syms", [4, 0])
def test_reference_decodes_its_own_subframes(ack_syms):
    """The uplink transmitter's TBs, CQIs and ACKs come back through the
    reference receiver at 30 dB; without ACK symbols nothing is erased."""
    cfg = {**CFG, "snr_db": 30.0, "ack_symbols": ack_syms}
    clean = uplink.build(cfg, 2**31 + 7, 3)
    gen = torch.Generator().manual_seed(7)
    iq = transmitter.add_noise(torch.as_tensor(clean.td), clean.p_sig, 30.0, gen).numpy()
    out = uplink.Receiver(cfg).pusch(iq, clean.noise_var(30.0))
    assert (out.payload == clean.payloads).all() and out.tb_ok.all()
    assert (out.cqi == clean.cqi).all() and out.iters.shape == (3, 1)
    if ack_syms:
        assert (out.ack == clean.ack).all()
    assert len(out.softbuf) == 1 and out.softbuf[0].shape == (3, 1, 3 * (2624 + 4))


def test_seed_gives_the_same_uplink_inputs():
    a, b = uplink.build(CFG, 2**33 + 1, 3), uplink.build(CFG, 2**33 + 1, 3)
    assert np.array_equal(a.td, b.td) and np.array_equal(a.payloads, b.payloads)
    assert np.array_equal(a.cqi, b.cqi) and np.array_equal(a.ack, b.ack)


def test_configuration_is_its_sources():
    """TS 36.213 Table 7.1.7.2.1-1 at I_TBS 19 and 100 PRB, segmented into 8
    blocks of K=5504; the CQI's 40 bits on 10 16QAM symbols; the code rate."""
    cfg = core.load_json("configs", "lte20_pusch_mcs20_uci")
    assert ra.tbs(cfg["i_tbs"], cfg["n_prb"]) == cfg["tbs"] == 43816
    plan = segmentation.plan(cfg["tbs"])
    assert plan.block_ks == (cfg["block_k"],) * cfg["code_blocks"] and plan.f == 0
    pmap = uplink.pusch_map(cfg)
    assert len(pmap.cqi_pos) == cfg["cqi_symbols"] == 10
    assert round(cfg["tbs"] / pmap.G, 2) == cfg["code_rate"]
    assert pmap.G == (12 * 1200 - 10) * 4


def test_demap_count_of_the_uplink():
    # 256 x (14,390 data symbols x 12 B read + 8 x 16,524 softbuffer values x 4 B written)
    d = 3 * (5504 + 4)
    assert demap.pdsch_bytes(256, 14390, [d] * 8) == 256 * (14390 * 12 + 8 * d * 4)


def _run(events):
    """Two marked steps, 0-10 ms and 10-20 ms (the trace's clock is us)."""
    x = lambda name, ts, dur: {"ph": "X", "name": name, "cat": "user_annotation",  # noqa: E731
                               "ts": ts, "dur": dur}
    return core.Run(trace=trace.records([x(trace.STEP, 0.0, 10_000.0),
                                         x(trace.STEP, 10_000.0, 10_000.0)]
                                        + [x(*e) for e in events]))


@pytest.mark.parametrize("metric,span", [("pusch_frontend_ms.ul", "pusch.frontend"),
                                         ("pusch_turbo_ms.ul", "pusch.turbo"),
                                         ("uci_ms.ul", "pusch.uci")])
def test_reader_reads_its_span(metric, span):
    assert core.reader(metric).read(_run([(span, 2_000.0, 2_000.0)])) == pytest.approx(1.0)
    assert core.reader(metric).read(_run([("pdsch.turbo", 2_000.0, 2_000.0)])) is None
    assert spans.ms_per_step(core.Run(), span) is None


@pytest.mark.parametrize("what", ["import perfbench.reference.uplink",
                                  "from perfbench import core; core.load_module('entries', 'pusch')"])
def test_loaded_modules(what):
    """A fresh interpreter holds no JAX after the import, and the reference
    nothing of the port."""
    code = (f"import sys; sys.path.insert(0, {str(core.ROOT)!r}); {what}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = set(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              check=True).stdout.split())
    assert not tops & {"jax", "jaxlib", "flax", "srsue_tpu"}
    if "reference" in what:
        assert "srsue_tpu_torch" not in tops


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["pusch_enb_b256", "tm1_b256_early_exit"])
def test_cell_on_the_card(cell):
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = core.measure(cell, 2**31 + 29, 2.0, False, time.perf_counter())
    assert out["correct"], out["compared"]
