"""The uplink's host modules of the torch port against the JAX reference's
(numpy on both sides): PUCCH formats 1/1a/SR and 2, the RM(20, A) code,
SRS, PRACH, UL power control, the SR/CQI schedules of ``UlCtrl`` and the
``UlHarq`` entity. Grids, waveforms and preamble tables equal to 1e-6 (the
same numpy operations, in practice equal); detections, decoded bits, hits
and lags, schedules, powers and HARQ sequences exactly equal.
"""

import dataclasses

import numpy as np
import pytest

from srsue_tpu.mac import ul_harq as ref_ul_harq
from srsue_tpu.phy import powerctrl as ref_pc
from srsue_tpu.phy import prach as ref_prach
from srsue_tpu.phy import pucch as ref_pucch
from srsue_tpu.phy import srs as ref_srs
from srsue_tpu.phy import uci as ref_uci
from srsue_tpu.phy import ue_ul_ctrl as ref_ulc
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.mac import ul_harq
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import powerctrl, prach, pucch, srs, uci, ue_ul_ctrl


def _mine(cell):
    return port_cell.Cell(**dataclasses.asdict(cell))


def _noise(rng, shape, scale):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


def _eq(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- PUCCH
@pytest.mark.parametrize("ack", [True, False, None], ids=["ack", "nack", "sr"])
@pytest.mark.parametrize("n_prb,cell_id,sf,n_pucch", [(25, 101, 3, 7), (6, 44, 0, 40),
                                                       (100, 42, 9, 80)])
def test_pucch_format1_matches_reference(ack, n_prb, cell_id, sf, n_pucch):
    cell = Cell(n_prb=n_prb, cell_id=cell_id)
    grid = pucch.encode_format1(_mine(cell), sf, n_pucch, ack=ack)
    grid_r = ref_pucch.encode_format1(cell, sf, n_pucch, ack=ack)
    assert grid.dtype == np.complex64
    _eq(grid, grid_r)
    rng = np.random.default_rng(n_pucch)
    noisy = grid_r + _noise(rng, grid_r.shape, 0.3)
    for res in (n_pucch, n_pucch + 1):  # the right resource and a wrong one
        got = pucch.detect_format1(_mine(cell), noisy, sf, res)
        ref = ref_pucch.detect_format1(cell, noisy, sf, res)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    metric, soft = pucch.detect_format1(_mine(cell), noisy, sf, n_pucch)
    m_off, _ = pucch.detect_format1(_mine(cell), _noise(rng, grid_r.shape, 0.3), sf, n_pucch)
    assert metric > 3 * m_off
    if ack is not None:
        assert (soft > 0) == ack == (ref_pucch.detect_format1(cell, noisy, sf, n_pucch)[1] > 0)


def test_pucch_tables_and_hopping_match_reference():
    np.testing.assert_array_equal(pucch.W4, ref_pucch.W4)
    assert pucch._PHI_TABLE == ref_pucch._PHI_TABLE
    assert (pucch.DATA_SYMS, pucch.RS_SYMS) == (ref_pucch.DATA_SYMS, ref_pucch.RS_SYMS)
    for cell_id in range(0, 504, 7):
        np.testing.assert_array_equal(pucch.base_seq12(cell_id), ref_pucch.base_seq12(cell_id))
    for cell in (Cell(n_prb=6, cell_id=1), Cell(n_prb=25, cell_id=301)):
        for n_pucch in (0, 5, 35, 36, 71, 72, 150):
            for slot in (0, 1):
                assert (pucch.pucch_prb(_mine(cell), n_pucch, slot)
                        == ref_pucch.pucch_prb(cell, n_pucch, slot))
        for ns in (0, 7, 19):
            for l in range(7):
                assert (pucch._cyclic_shift_per_symbol(_mine(cell), ns, l, 11)
                        == ref_pucch._cyclic_shift_per_symbol(cell, ns, l, 11))


# ------------------------------------------------------------ RM20, format 2
@pytest.mark.parametrize("a", [2, 4, 6, 10, 13])
def test_rm20_matches_reference(a):
    np.testing.assert_array_equal(uci.RM20_BASIS, ref_uci.RM20_BASIS)
    rng = np.random.default_rng(a)
    if a <= 11:
        np.testing.assert_array_equal(uci._codebook(a), ref_uci._codebook(a))
    for _ in range(8):
        bits = rng.integers(0, 2, a).astype(np.uint8)
        cw = uci.rm20_encode(bits)
        np.testing.assert_array_equal(cw, ref_uci.rm20_encode(bits))
        if a > 11:
            continue
        llr = ((1.0 - 2.0 * cw) * 2.0 + rng.standard_normal(20) * 1.5).astype(np.float32)
        got, score = uci.rm20_decode(llr, a)
        ref, score_r = ref_uci.rm20_decode(llr, a)
        np.testing.assert_array_equal(got, ref)
        assert score == score_r


@pytest.mark.parametrize("n_bits", [4, 6, 8])
def test_pucch_format2_matches_reference(n_bits):
    cell = Cell(n_prb=25, cell_id=91)
    rng = np.random.default_rng(n_bits)
    for sf, n_pucch in ((1, 2), (6, 30)):
        bits = rng.integers(0, 2, n_bits).astype(np.uint8)
        grid = uci.encode_format2(_mine(cell), sf, n_pucch, bits)
        grid_r = ref_uci.encode_format2(cell, sf, n_pucch, bits)
        _eq(grid, grid_r)
        noisy = grid_r + _noise(rng, grid_r.shape, 0.1)
        got, score = uci.decode_format2(_mine(cell), noisy, sf, n_pucch, n_bits)
        ref, score_r = ref_uci.decode_format2(cell, noisy, sf, n_pucch, n_bits)
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, bits)
        np.testing.assert_allclose(score, score_r, rtol=1e-5)


# --------------------------------------------------------------------- SRS
@pytest.mark.parametrize("n_prb_srs,prb_offset,cs,comb", [(8, 2, 3, 0), (4, 0, 0, 1),
                                                          (16, 5, 7, 1), (2, 1, 1, 0)])
def test_srs_matches_reference(n_prb_srs, prb_offset, cs, comb):
    cell = Cell(n_prb=25, cell_id=30)
    seq = srs.generate(_mine(cell), n_prb_srs, cs, comb)
    np.testing.assert_array_equal(seq, ref_srs.generate(cell, n_prb_srs, cs, comb))
    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    grid_r = grid.copy()
    srs.map_to_grid(_mine(cell), grid, n_prb_srs, prb_offset, cs, comb)
    ref_srs.map_to_grid(cell, grid_r, n_prb_srs, prb_offset, cs, comb)
    np.testing.assert_array_equal(grid, grid_r)
    noisy = grid + _noise(np.random.default_rng(cs), grid.shape, 0.05)
    for test_cs in (cs, (cs + 3) % 8):
        got = srs.detect(_mine(cell), noisy, n_prb_srs, prb_offset, test_cs, comb)
        assert got == pytest.approx(
            ref_srs.detect(cell, noisy, n_prb_srs, prb_offset, test_cs, comb), rel=1e-6)
    assert srs.detect(_mine(cell), noisy, n_prb_srs, prb_offset, cs, comb) > 0.9


def test_srs_schedules_match_reference():
    assert srs.SFC_TABLE == ref_srs.SFC_TABLE
    for config in range(16):
        for tti in range(40):
            assert srs.cell_srs_subframe(config, tti) == ref_srs.cell_srs_subframe(config, tti)
    for i_srs in (-1, 0, 1, 2, 6, 7, 16, 17, 36, 37, 76, 77, 156, 157, 316, 317, 636, 637, 700):
        got = [t for t in range(700) if srs.ue_srs_subframe(i_srs, t)]
        assert got == [t for t in range(700) if ref_srs.ue_srs_subframe(i_srs, t)], i_srs


# ------------------------------------------------------------------- PRACH
def test_prach_tables_match_reference():
    assert prach.NCS_TABLE == ref_prach.NCS_TABLE and prach.NZC == ref_prach.NZC
    assert list(prach._logical_table()) == list(ref_prach._logical_table())
    for u in (1, 129, 838):
        np.testing.assert_array_equal(prach.root_sequence(u), ref_prach.root_sequence(u))
    for root, zc in ((128, 5), (0, 0), (837, 15), (22, 1)):
        np.testing.assert_array_equal(prach.preamble_table(root, zc),
                                      ref_prach.preamble_table(root, zc))


@pytest.mark.parametrize("n_prb,preamble,freq_offset", [(25, 0, 0), (25, 17, 4), (6, 63, 0),
                                                        (100, 42, 10)])
def test_prach_detect_matches_reference(n_prb, preamble, freq_offset):
    cell = Cell(n_prb=n_prb, cell_id=5)
    td = prach.waveform(_mine(cell), 128, 5, preamble, freq_offset)
    td_r = ref_prach.waveform(cell, 128, 5, preamble, freq_offset)
    _eq(td, td_r)
    rng = np.random.default_rng(preamble)
    delay = 3  # samples of round-trip delay: the lag
    rx = np.concatenate([np.zeros(delay, np.complex64), td_r])[:len(td_r)]
    rx = rx + _noise(rng, rx.shape, 0.05)
    hits = prach.detect(_mine(cell), rx, 128, 5, freq_offset)
    hits_r = ref_prach.detect(cell, rx, 128, 5, freq_offset)
    assert [(p, lag) for p, _, lag in hits] == [(p, lag) for p, _, lag in hits_r]
    np.testing.assert_allclose([m for _, m, _ in hits], [m for _, m, _ in hits_r], rtol=1e-6)
    best = max(hits, key=lambda h: h[1])
    assert best[0] == preamble
    noise = _noise(rng, rx.shape, 0.3)
    assert prach.detect(_mine(cell), noise, 128, 5, threshold=13.0) == ref_prach.detect(
        cell, noise, 128, 5, threshold=13.0) == []


# ----------------------------------------------------------- power control
def test_power_control_matches_reference():
    cfgs = [(powerctrl.UlPowerConfig(), ref_pc.UlPowerConfig())]
    kw = dict(p_max_dbm=20.0, p0_nominal_pusch=-90.0, alpha=1.0, p0_nominal_pucch=-100.0,
              delta_preamble_msg3=3.0)
    cfgs.append((powerctrl.UlPowerConfig(**kw), ref_pc.UlPowerConfig(**kw)))
    assert [f.name for f in dataclasses.fields(powerctrl.UlPowerConfig)] == [
        f.name for f in dataclasses.fields(ref_pc.UlPowerConfig)]
    assert powerctrl.TPC_ACC == ref_pc.TPC_ACC
    for cfg, cfg_r in cfgs:
        p, p_r = powerctrl.UlPower(cfg), ref_pc.UlPower(cfg_r)
        for tpc in (3, 3, 0, 2, 1, 7, 3):
            p.apply_tpc_pusch(tpc)
            p_r.apply_tpc_pusch(tpc)
            p.apply_tpc_pucch((tpc + 1) % 4)
            p_r.apply_tpc_pucch((tpc + 1) % 4)
            for n_prb in (0, 1, 6, 50, 100):
                for pl in (60.0, 95.5, 140.0):
                    assert p.pusch_power_dbm(n_prb, pl, 1.5) == p_r.pusch_power_dbm(n_prb, pl, 1.5)
                    assert p.headroom_db(n_prb, pl) == p_r.headroom_db(n_prb, pl)
            for pl in (60.0, 140.0):
                assert p.pucch_power_dbm(pl, 2.0) == p_r.pucch_power_dbm(pl, 2.0)
                assert p.prach_power_dbm(pl, -104.0) == p_r.prach_power_dbm(pl, -104.0)
        assert (p.f_pusch, p.g_pucch) == (p_r.f_pusch, p_r.g_pucch)
    assert powerctrl.UlPower().headroom_db(1, 40.0) > 40  # unclamped


# ----------------------------------------------------------- UL control
def test_sr_and_cqi_tables_match_reference():
    for i in list(range(-2, 155)) + [155, 400]:
        for fn in ("sr_period_offset", "cqi_period_offset"):
            try:
                want = getattr(ref_ulc, fn)(i)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(ue_ul_ctrl, fn)(i)
                continue
            assert getattr(ue_ul_ctrl, fn)(i) == want, (fn, i)
    for i in (156, 200, 316, 317):
        try:
            want = ref_ulc.cqi_period_offset(i)
        except ValueError:
            with pytest.raises(ValueError):
                ue_ul_ctrl.cqi_period_offset(i)
            continue
        assert ue_ul_ctrl.cqi_period_offset(i) == want
    for n_prb in (6, 7, 10, 15, 25, 26, 50, 63, 75, 100):
        for fn in ("subband_geometry", "subband_count", "subband_label_bits"):
            assert getattr(ue_ul_ctrl, fn)(n_prb) == getattr(ref_ulc, fn)(n_prb)
        for j in range(ue_ul_ctrl.subband_geometry(n_prb)[1]):
            assert ue_ul_ctrl.part_subbands(n_prb, j) == ref_ulc.part_subbands(n_prb, j)
        for i_cqi, k in ((2, None), (7, 1), (17, 2), (40, 3)):
            for tti in range(200):
                assert (ue_ul_ctrl.cqi_report_kind(i_cqi, tti, n_prb, k)
                        == ref_ulc.cqi_report_kind(i_cqi, tti, n_prb, k))


@pytest.mark.parametrize("subband_k", [None, 1, 2])
def test_ul_ctrl_schedule_matches_reference(subband_k):
    kw = dict(sr_config_index=7, sr_pucch_resource=3, cqi_config_index=9,
              cqi_pucch_resource=5, cqi_subband_k=subband_k, n_prb=50)
    ctl = ue_ul_ctrl.UlCtrl(ue_ul_ctrl.UlCtrlConfig(**kw))
    ref = ref_ulc.UlCtrl(ref_ulc.UlCtrlConfig(**kw))
    rng = np.random.default_rng(3)
    n_sb = ue_ul_ctrl.subband_count(50)
    for tti in range(400):
        snr = float(rng.uniform(-8, 25))
        ctl.update_snr(snr)
        ref.update_snr(snr)
        if tti == 150:  # subband reports before this one carry the wideband CQI
            sub = rng.uniform(-5, 25, n_sb)
            ctl.update_subband_snr(sub)
            ref.update_subband_snr(sub)
        assert ctl.sr_opportunity(tti) == ref.sr_opportunity(tti)
        got, want = ctl.cqi_for_tti(tti), ref.cqi_for_tti(tti)
        assert (got is None) == (want is None), tti
        if got is not None:
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.uint8
    assert ctl.metrics == ref.metrics and ctl.metrics["cqi_sent"] > 0
    assert ctl.last_snr_db == ref.last_snr_db
    assert ue_ul_ctrl.UlCtrl(ue_ul_ctrl.UlCtrlConfig()).cqi_for_tti(0) is None


def test_cqi_helpers_match_reference():
    from srsue_tpu.phy import ra as ref_ra
    from srsue_tpu_torch.phy import ra

    for snr in np.linspace(-12, 30, 211):
        assert ra.cqi_from_snr(float(snr)) == ref_ra.cqi_from_snr(float(snr))
    for cqi in range(16):
        assert ra.mcs_from_cqi(cqi) == ref_ra.mcs_from_cqi(cqi)


# ----------------------------------------------------------------- UL HARQ
def _drive(h, script):
    out = []
    for op, *args in script:
        res = getattr(h, op)(*args)
        out.append(res)
        out.append(([(p.payload, p.n_retx, p.current_irv, p.is_msg3, p.ndi) for p in h.procs],
                    dict(h.metrics)))
    return out


@pytest.mark.parametrize("max_retx", [3, 5])
def test_ul_harq_sequences_match_reference(max_retx):
    assert (ul_harq.RV_SEQ, ul_harq.N_HARQ_PROC, ul_harq.HARQ_DELAY) == (
        ref_ul_harq.RV_SEQ, ref_ul_harq.N_HARQ_PROC, ref_ul_harq.HARQ_DELAY)
    for tti in range(20):
        assert ul_harq.pid_of_tti(tti) == ref_ul_harq.pid_of_tti(tti)
    script = [("new_tx", 4, b"abc", False, True), ("is_new_tx", 4, True), ("is_new_tx", 12, False),
              ("retx", 12), ("retx", 20), ("retx", 28, 1), ("retx", 36, 9), ("retx", 44),
              ("retx", 52), ("harq_feedback", 60, True), ("has_pending", 4),
              ("new_tx", 5, b"msg3", True), ("is_new_tx", 13, None), ("retx", 13),
              ("harq_feedback", 21, False), ("retx", 21), ("harq_feedback", 29, True),
              ("retx", 6), ("is_new_tx", 6, True), ("new_tx", 7, b"x" * 40, False, None),
              ("is_new_tx", 15, True), ("reset",), ("has_pending", 7), ("retx", 7)]
    got = _drive(ul_harq.UlHarq(max_retx=max_retx, max_msg3_retx=2), script)
    want = _drive(ref_ul_harq.UlHarq(max_retx=max_retx, max_msg3_retx=2), script)
    assert got == want
