"""The loaded uplink cell ``pusch_enb_7ue_b256`` on the CPU, shrunk to four UEs
on a 25 PRB cell (two 6 PRB 16QAM, two 4 PRB QPSK: two allocation sizes, two
code block sizes), its plain reference alone and against ``uplink.py``, its
bf16 control, and the readers of its two counters."""

import time

import numpy as np
import pytest
import torch

from perfbench import core, trace
from perfbench.reference import transmitter, uplink, uplink_cell
from perfbench.reference.lte import ra, segmentation

CELL = "pusch_enb_7ue_b256"
FULL = core.load_json("configs", "lte20_pusch_7ue_mixed")
SMALL = {"n_prb": 25, "tbs": 2 * 1352 + 2 * 176, "ues": [
    {**FULL["ues"][0], "n_prb": 6, "prb_start": 1, "i_tbs": 12, "tbs": 1352},
    {**FULL["ues"][2], "n_prb": 6, "prb_start": 7, "tbs": 1352},
    {**FULL["ues"][4], "n_prb": 4, "prb_start": 13, "i_tbs": 2, "tbs": 176},
    {**FULL["ues"][6], "n_prb": 4, "prb_start": 17}]}
SHRINK = {"batch": 4, "n_batches": 2, "sample": {"steps": 2, "rows": 2}}


def measure(hooks=None, seed=2**31 + 41):
    return core.measure(CELL, seed, 0.5, False, time.perf_counter(), device="cpu",
                        hooks=hooks, cfg_over=SMALL, wl_over=SHRINK)


def test_port_equals_reference():
    out = measure()
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    wrong = {k: v["value"] for k, v in out["compared"].items() if k.endswith("_wrong")}
    assert set(wrong) == {"payload_bits_wrong", "tb_flags_wrong", "iters_wrong", "cqi_wrong",
                          "ack_wrong"} and not any(wrong.values())
    assert out["compared"]["softbuf_rel_err"]["value"] < 1e-5
    assert set(out["metrics"]) == {"batch_p95_ms", "decoded_mbps", "setup_s"}


def _altered(field, ue):
    """A hook that flips UE `ue`'s first decision of `field` in every
    subframe."""
    at = {"payload": 0, "cqi": 3, "ack": 4}[field]

    def hook(runner):
        step = runner.step

        def broken(i):
            out = step(i)
            parts = list(out.ues[ue])
            value = np.array(parts[at], copy=True)
            if value.dtype == bool:
                value ^= True
            else:
                value[..., 0] ^= 1
            parts[at] = value
            out.ues[ue] = tuple(parts)
            return out

        runner.step = broken
        return runner
    return hook


@pytest.mark.parametrize("field,ue,number", [("payload", 3, "payload_bits_wrong"),
                                             ("cqi", 0, "cqi_wrong"), ("ack", 2, "ack_wrong")])
def test_altered_answer_is_not_correct(field, ue, number):
    out = measure(hooks=_altered(field, ue))
    assert not out["correct"]
    assert out["compared"][number]["value"] > 0


def test_one_copy_gives_each_ues_outputs():
    """The step's one host read splits back into every UE's outputs as each
    tensor's own read gives them, with and without a CQI or an ACK."""
    g = torch.Generator().manual_seed(5)
    b = 3

    def ue(tbs, c, cqi, ack):
        return ((torch.randint(0, 2, (b, tbs), generator=g, dtype=torch.uint8),
                 torch.randint(0, 2, (b,), generator=g).bool(),
                 torch.randint(1, 9, (b, c), generator=g, dtype=torch.int32)),
                (torch.randint(0, 2, (b, 4), generator=g, dtype=torch.uint8) if cqi else None,
                 torch.randint(0, 2, (b,), generator=g).bool() if ack else None))

    ues = [ue(40, 2, True, True), ue(16, 1, False, True), ue(8, 1, False, False)]
    got = core.load_module("entries", "pusch_cell").to_host(*zip(*ues), b)
    for (d, u), host in zip(ues, got, strict=True):
        want = (*(v.numpy() for v in d), np.zeros((b, 0), np.uint8) if u[0] is None
                else u[0].numpy(), np.zeros(b, bool) if u[1] is None else u[1].numpy())
        for w, h in zip(want, host, strict=True):
            assert h.dtype == w.dtype and h.shape == w.shape
            np.testing.assert_array_equal(h, w)


def test_control_is_not_correct():
    r = core.load_module("entries", "pusch_cell").readings(CELL, 2**32 + 7, "cpu",
                                                           cfg_over=SMALL, wl_over=SHRINK)
    assert not r["correct"], r
    assert r["numbers"]["softbuf_rel_err"] > 1e-4


def test_one_full_band_ue_is_the_uplink_reference():
    """One UE over a whole 6 PRB cell: the same subframes from the seed and
    the same decode as ``uplink.py``'s."""
    one = core.load_json("configs", "lte20_pusch_mcs20_uci")
    one = {**one, "n_prb": 6, "tbs": 2600}
    cell = {**FULL, "n_prb": 6, "ues": [{k: one[k] for k in (
        "n_prb", "prb_start", "qm", "tbs", "rnti", "cyclic_shift", "cqi_bits",
        "cqi_repetition", "ack_symbols")}]}
    a, b = uplink_cell.build(cell, 2**33 + 3, 3), uplink.build(one, 2**33 + 3, 3)
    assert np.array_equal(a.td, b.td) and a.p_sig == b.p_sig
    assert np.array_equal(a.payloads[0], b.payloads) and np.array_equal(a.cqi[0], b.cqi)
    assert np.array_equal(a.ack[0], b.ack)
    gen = torch.Generator().manual_seed(3)
    iq = transmitter.add_noise(torch.as_tensor(b.td), b.p_sig, 20.0, gen).numpy()
    (got,), want = (uplink_cell.Receiver(cell).pusch(iq, b.noise_var(20.0)),
                    uplink.Receiver(one).pusch(iq, b.noise_var(20.0)))
    for f in ("payload", "tb_ok", "iters", "cqi", "ack"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for x, y in zip(got.softbuf, want.softbuf, strict=True):
        assert np.array_equal(x, y)


def test_reference_decodes_its_own_subframes():
    """Every UE's TB, CQI and ACK comes back at 30 dB, each UE decoded on its
    own band."""
    cfg = {**FULL, **SMALL}
    clean = uplink_cell.build(cfg, 2**31 + 5, 2)
    gen = torch.Generator().manual_seed(5)
    iq = transmitter.add_noise(torch.as_tensor(clean.td), clean.p_sig, 30.0, gen).numpy()
    out = uplink_cell.Receiver(cfg).pusch(iq, clean.noise_var(30.0))
    assert len(out) == 4
    for u, got in enumerate(out):
        assert (got.payload == clean.payloads[u]).all() and got.tb_ok.all()
        assert (got.cqi == clean.cqi[u]).all() and (got.ack == clean.ack[u]).all()


def test_configuration_is_its_sources():
    """Each UE's TBS is TS 36.213 Table 7.1.7.2.1-1's at its I_TBS and PRB
    count, segmented as the configuration says; the bands are disjoint,
    inside PRB 2-97 (the PUCCH region empty), and sum to the subframe's
    29,472 TB bits in 9 code blocks of 4 sizes."""
    used = set()
    blocks = []
    for ue in FULL["ues"]:
        assert ra.tbs(ue["i_tbs"], ue["n_prb"]) == ue["tbs"]
        plan = segmentation.plan(ue["tbs"])
        assert plan.block_ks == (ue["block_k"],) * ue["code_blocks"]
        band = set(range(ue["prb_start"], ue["prb_start"] + ue["n_prb"]))
        assert not band & used and not band & set(FULL["pucch_prbs"])
        used |= band
        blocks += plan.block_ks
        assert ue["cqi_symbols"] == len(uplink_cell.pusch_map(FULL, ue).cqi_pos)
    assert used == set(range(2, 98))
    assert sum(ue["tbs"] for ue in FULL["ues"]) == FULL["tbs"] == 29472
    assert len(blocks) == FULL["code_blocks"] == 9 and len(set(blocks)) == 4


def _run(events):
    """Two marked steps, 0-10 ms and 10-20 ms (the trace's clock is us)."""
    x = lambda name, ts, dur: {"ph": "X", "name": name, "cat": "user_annotation",  # noqa: E731
                               "ts": ts, "dur": dur}
    return core.Run(trace=trace.records([x(trace.STEP, 0.0, 10_000.0),
                                         x(trace.STEP, 10_000.0, 10_000.0)]
                                        + [x(*e) for e in events]))


@pytest.mark.parametrize("metric,span", [("k_groups.mu", "pusch.k_group"),
                                         ("idft_groups.mu", "pusch.idft_group")])
def test_counter_reads_its_spans(metric, span):
    spans = [(span, 1_000.0 * i, 100.0) for i in range(8)]
    assert core.reader(metric).read(_run(spans)) == pytest.approx(4.0)
    assert core.reader(metric).read(_run([("pusch.turbo", 2_000.0, 2_000.0)])) is None
    assert core.reader(metric).read(core.Run()) is None


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the cell at its own size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = core.measure(CELL, 2**31 + 31, 2.0, False, time.perf_counter())
    assert out["correct"], out["compared"]


@pytest.mark.parametrize("what", [
    "import perfbench.reference.uplink_cell, perfbench.reference.blind",
    "from perfbench import core; "
    "[core.load_module('entries', n) for n in ('pusch_cell', 'blind')]"])
def test_loaded_modules(what):
    """A fresh interpreter holds no JAX after the import, and the references
    nothing of the port."""
    import subprocess
    import sys

    code = (f"import sys; sys.path.insert(0, {str(core.ROOT)!r}); {what}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    tops = set(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              check=True).stdout.split())
    assert not tops & {"jax", "jaxlib", "flax", "srsue_tpu"}
    if "reference" in what:
        assert "srsue_tpu_torch" not in tops
