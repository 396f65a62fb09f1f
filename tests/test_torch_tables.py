"""Host tables of the torch port against the JAX reference: TBS, grants,
segmentation, QPP, trellis, turbo encoder, rate-matching maps, the
PdschCodec and PuschCodec tables, the PBCH REs and the radios. All
comparisons are exact (integer tables, host numpy)."""

import dataclasses
import logging

import numpy as np
import pytest

from srsue_tpu.mac import pdu as ref_pdu
from srsue_tpu.phy import cell as ref_cell
from srsue_tpu.phy import crc as ref_crc
from srsue_tpu.phy import pdsch as ref_pdsch
from srsue_tpu.phy import pusch as ref_pusch
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy import regrid as ref_regrid
from srsue_tpu.phy import segmentation as ref_seg
from srsue_tpu.phy import seq as ref_seq
from srsue_tpu.phy import turbo as ref_turbo
from srsue_tpu.phy.cell import Cell
from srsue_tpu.radio import radio as ref_radio
from srsue_tpu_torch.mac import pdu, rnti
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import (crc, pdsch, pusch, ra, ratematch, regrid, segmentation, seq,
                                  turbo)
from srsue_tpu_torch.radio import radio


def _mine(obj):
    """The port's own Cell or DlGrant with the fields of the reference's."""
    return getattr(port_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _same(a, b):
    """Equal fields in a dataclass of the same name (the port keeps its own
    copy of the reference's Cell and grants)."""
    assert type(a).__name__ == type(b).__name__
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


def test_tbs_table_every_cell():
    np.testing.assert_array_equal(ra.TBS_TABLE, ref_ra.TBS_TABLE)
    assert ra.TBS_EXACT_WIDTHS == ref_ra.TBS_EXACT_WIDTHS
    for i_tbs in range(27):
        for n_prb in range(1, 111):
            assert ra.tbs(i_tbs, n_prb) == int(ref_ra.TBS_TABLE[i_tbs, n_prb - 1])


@pytest.mark.parametrize("strict", [False, True])
def test_reconstructed_tbs_width_warns_once_or_raises(strict, monkeypatch, caplog):
    """A width outside TBS_EXACT_WIDTHS holds generator-model values: the
    lookup warns once per width, and raises under SRSUE_TPU_TBS_STRICT=1, on
    both sides; transcribed widths do neither."""
    monkeypatch.setattr(ra, "_warned_widths", set())
    monkeypatch.setattr(ref_ra, "_warned_widths", set())
    if strict:
        monkeypatch.setenv("SRSUE_TPU_TBS_STRICT", "1")
    else:
        monkeypatch.delenv("SRSUE_TPU_TBS_STRICT", raising=False)
    assert 30 not in ra.TBS_EXACT_WIDTHS and 25 in ra.TBS_EXACT_WIDTHS
    for mod, logger in ((ra, "srsue_tpu_torch.ra"), (ref_ra, "srsue_tpu.ra")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            if strict:
                for width in (30, 99):
                    with pytest.raises(ValueError, match="reconstructed"):
                        mod.tbs(3, width)
                with pytest.raises(ValueError, match="reconstructed"):
                    mod.dl_grant(100, 5, n_prb_alloc=30)
            else:
                assert mod.tbs(3, 30) == mod.tbs(3, 30) == int(ref_ra.TBS_TABLE[3, 29])
                assert mod.tbs(7, 30) == int(ref_ra.TBS_TABLE[7, 29])
                mod.tbs(3, 99)
            assert mod.tbs(3, 25) == 1416 and mod.tbs(26, 100) == 75376
        warned = [r for r in caplog.records if r.name == logger]
        assert len(warned) == (0 if strict else 2), [r.getMessage() for r in warned]
        assert all("reconstructed" in r.getMessage() for r in warned)
    with pytest.raises(ValueError, match="out of range"):
        ra.tbs(3, 111)


@pytest.mark.parametrize("n_prb", [6, 15, 25, 50, 75, 100])
def test_dl_grant_fields(n_prb):
    for mcs in range(29):
        for rv in (0, 2):
            _same(ra.dl_grant(n_prb, mcs, rv=rv), ref_ra.dl_grant(n_prb, mcs, rv=rv))
    _same(ra.dl_grant(n_prb, 10, n_prb_alloc=3, prb_start=2),
          ref_ra.dl_grant(n_prb, 10, n_prb_alloc=3, prb_start=2))


def test_segmentation_plan_across_tbs():
    values = sorted(set(ref_ra.TBS_TABLE.ravel().tolist()) | {16, 500, 6120, 6121, 12000})
    for tbs in values:
        mine, ref = segmentation.plan(tbs), ref_seg.plan(tbs)
        assert (mine.tbs, mine.c, mine.k_plus, mine.k_minus, mine.c_plus,
                mine.c_minus, mine.f) == (ref.tbs, ref.c, ref.k_plus, ref.k_minus,
                                          ref.c_plus, ref.c_minus, ref.f), tbs
        assert mine.block_ks == ref.block_ks
        assert mine.uniform_k == ref.uniform_k
    rng = np.random.default_rng(0)
    for tbs in (500, 7736, 14112):
        bits = rng.integers(0, 2, tbs).astype(np.uint8)
        blocks = segmentation.segment(bits)
        for a, b in zip(blocks, ref_seg.segment(bits), strict=True):
            np.testing.assert_array_equal(a, b)
        # desegment, with every block's CRC good and then with each one broken
        for bad in (None, *range(len(blocks))):
            got = [b.copy() for b in blocks]
            if bad is not None:
                got[bad][-1] ^= 1
            (mine, ok), (ref, ref_ok) = (segmentation.desegment(got, tbs),
                                         ref_seg.desegment(got, tbs))
            np.testing.assert_array_equal(mine, ref)
            assert ok == ref_ok == (bad is None)


def test_qpp_and_trellis_tables():
    np.testing.assert_array_equal(turbo.VALID_K, ref_turbo.VALID_K)
    for k in turbo.VALID_K.tolist():
        np.testing.assert_array_equal(turbo.qpp_perm(k), ref_turbo.qpp_perm(k))
        np.testing.assert_array_equal(turbo.qpp_inv(k), ref_turbo.qpp_inv(k))
    for a, b in zip(turbo._trellis(), ref_turbo._trellis(), strict=True):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(turbo._prev_tables(), ref_turbo._prev_tables(), strict=True):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [40, 528, 1056, 5824])
def test_numpy_encoder_matches_reference(k):
    bits = np.random.default_rng(k).integers(0, 2, k).astype(np.uint8)
    np.testing.assert_array_equal(turbo.encode(bits), ref_turbo.encode(bits))


def test_vectorised_encoder_over_the_qpp_table():
    """The encoder without a per-bit loop (XOR prefixes per residue class of
    the period-7 feedback) equals the reference bit for bit on every 4th K
    of the QPP table, the first and the largest, with the tail multiplexing;
    all-zero and all-one blocks included."""
    rng = np.random.default_rng(7)
    ks = sorted(set(turbo.VALID_K[::4].tolist()) | {40, 6144})
    for k in ks:
        bits = rng.integers(0, 2, k).astype(np.uint8)
        np.testing.assert_array_equal(turbo.encode(bits), ref_turbo.encode(bits), err_msg=str(k))
    for k in (40, 1056):
        for fill in (0, 1):
            bits = np.full(k, fill, np.uint8)
            np.testing.assert_array_equal(turbo.encode(bits), ref_turbo.encode(bits))
    with pytest.raises(ValueError, match="invalid turbo K"):
        turbo.encode(np.zeros(41, np.uint8))


def test_turbo_rm_indices():
    cases = []
    for k in (40, 528, 3904, 5824):
        ks = k + 4
        for rv in range(4):
            # E below, near and (with repeats) above the circular buffer
            for e in (60, 3 * ks - 7, 3 * ks + 500):
                for f in (0, 8) if k < 1000 else (0,):
                    cases.append((ks, e, rv, f))
    for ks, e, rv, f in cases:
        np.testing.assert_array_equal(
            ratematch.turbo_rm_indices(ks, e, rv, n_filler=f),
            ref_rm.turbo_rm_indices(ks, e, rv, n_filler=f))
    np.testing.assert_array_equal(ratematch.turbo_rm_indices(532, 900, 1, n_cb=1200),
                                  ref_rm.turbo_rm_indices(532, 900, 1, n_cb=1200))


CODEC_CASES = [
    (Cell(n_prb=6, cell_id=17), 5, 1, 0),
    (Cell(n_prb=6, cell_id=5), 6, 4, 2),
    (Cell(n_prb=6, cell_id=2), 4, 0, 0),
    (Cell(n_prb=25, cell_id=301), 17, 3, 0),
    (Cell(n_prb=100, cell_id=42), 28, 6, 0),
]


@pytest.mark.parametrize("cell,mcs,subframe,rv", CODEC_CASES)
def test_codec_tables_and_from_arrays(cell, mcs, subframe, rv):
    grant = ref_ra.dl_grant(cell.n_prb, mcs, rv=rv)
    ref = ref_pdsch.PdschCodec(cell, grant, rnti=0x1234, subframe=subframe, cfi=1)
    pcell, pgrant = _mine(cell), _mine(grant)
    mine = pdsch.PdschCodec(pcell, pgrant, rnti=0x1234, subframe=subframe, cfi=1, device="cpu")
    rt = pdsch.PdschCodec.from_arrays(
        pcell, pgrant, ref.re_idx, ref.rm_idx, ref.scr_pm1, ref._blk_crc,
        ref._tb_crc, "cpu", subframe=subframe)
    for c in (mine, rt):
        np.testing.assert_array_equal(c.re_idx, ref.re_idx)
        assert c.G == ref.G and c.block_ks == ref.block_ks
        np.testing.assert_array_equal(c.e_offsets, ref.e_offsets)
        for a, b in zip(c.rm_idx, ref.rm_idx, strict=True):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c.scr_pm1, ref.scr_pm1)
        np.testing.assert_array_equal(c.scr_bits, ref.scr_bits)
        assert c.blk_crc.keys() == ref._blk_crc.keys()
        for k in c.blk_crc:
            np.testing.assert_array_equal(c.blk_crc[k], ref._blk_crc[k])
        np.testing.assert_array_equal(c.tb_crc, ref._tb_crc)
    if cell.n_prb <= 25:
        payload = np.random.default_rng(1).integers(0, 2, grant.tbs).astype(np.uint8)
        np.testing.assert_array_equal(mine.encode(payload), ref.encode(payload))
        np.testing.assert_array_equal(mine.encode_symbols(payload),
                                      ref.encode_symbols(payload))


def _ul_grant(n_prb, mcs, rv=0, tbs=None):
    g = ref_ra.dl_grant(n_prb, mcs, rv=rv)
    return ref_cell.UlGrant(n_prb=g.n_prb, prb_start=g.prb_start, mcs=mcs, mod_order=g.mod_order,
                            tbs=tbs or g.tbs, rv=rv)


PUSCH_CASES = [  # (cell, grant, subframe, n_cqi_bits, with_ack)
    (Cell(n_prb=6, cell_id=17), _ul_grant(6, 9), 2, 0, False),
    (Cell(n_prb=6, cell_id=5), _ul_grant(6, 9, rv=2), 7, 6, True),
    (Cell(n_prb=6, cell_id=17), _ul_grant(6, 5, tbs=500), 1, 4, False),  # filler bits
    (Cell(n_prb=25, cell_id=301), _ul_grant(25, 16, rv=3), 2, 4, True),
    (Cell(n_prb=100, cell_id=42), _ul_grant(100, 28), 2, 0, False),  # the full-width grant
    (Cell(n_prb=100, cell_id=42), _ul_grant(50, 20), 2, 4, True),  # bench.py's UL grant + UCI
]


@pytest.mark.parametrize("cell,grant,subframe,n_cqi,ack", PUSCH_CASES)
def test_pusch_codec_tables_match_reference(cell, grant, subframe, n_cqi, ack):
    """PuschCodec's host tables equal the reference's, and the block CRC
    matrices it takes from pdsch.blk_crc_matrix equal the ones the
    reference's decode_softbuffers builds inline."""
    ref = ref_pusch.PuschCodec(cell, grant, 0x1234, subframe, n_cqi_bits=n_cqi, with_ack=ack)
    mine = pusch.PuschCodec(_mine(cell), _mine(grant), 0x1234, subframe, n_cqi_bits=n_cqi,
                            with_ack=ack, device="cpu")
    for name in ("m_sc", "n_data_sym", "n_re", "qm", "G", "E"):
        assert getattr(mine, name) == getattr(ref, name), name
    for name in ("cqi_pos", "ack_pos", "data_pos", "_ack_erase", "e_offsets", "scr_bits",
                 "scr_pm1"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
    for a, b in zip(mine.rm_idx, ref.rm_idx, strict=True):
        np.testing.assert_array_equal(a, b)
    p = ref.plan
    assert mine.plan.block_ks == p.block_ks and mine.plan.f == p.f
    for i, k in enumerate(p.block_ks):  # the reference's inline construction
        m = np.zeros((k, 24), np.uint8)
        f = p.f if i == 0 else 0
        m[f:k - 24] = ref_crc.crc_matrix(k - 24 - f, "24A") if p.c == 1 else 0
        if p.c > 1:
            m[:k - 24] = ref_crc.crc_matrix(k - 24, "24B")
        m[k - 24:] = np.eye(24, dtype=np.uint8)
        np.testing.assert_array_equal(mine.blk_crc[k], m)
        np.testing.assert_array_equal(pdsch.blk_crc_matrix(mine.plan, i, k), m)
    if cell.n_prb == 100 and grant.n_prb == 100:
        assert (grant.tbs, p.c, p.block_ks[0], mine.G) == (75376, 13, 5824, 86400)


# ------------------------------------------- the port's copies of host tables
COPY_CELLS = [Cell(n_prb=6, cell_id=17), Cell(n_prb=15, cell_id=150, n_ports=2),
              Cell(n_prb=25, cell_id=301), Cell(n_prb=100, cell_id=42),
              Cell(n_prb=50, cell_id=7, extended_cp=True)]


@pytest.mark.parametrize("cell", COPY_CELLS, ids=lambda c: f"{c.n_prb}prb_{c.cell_id}")
def test_cell_and_regrid_copies_match_reference(cell):
    mine = _mine(cell)
    for name in ("nfft", "srate", "n_sc", "n_sym_slot", "n_sym_sf", "cp_lengths", "sf_len",
                 "slot_len", "n_id_1", "n_id_2", "vshift"):
        assert getattr(mine, name) == getattr(cell, name), name
    assert regrid.sync_sc(mine).tolist() == ref_regrid.sync_sc(cell).tolist()
    assert regrid.pss_symbol(mine) == ref_regrid.pss_symbol(cell)
    assert regrid.sss_symbol(mine) == ref_regrid.sss_symbol(cell)
    for cfi in (1, 2, 3):
        assert regrid.control_span(mine, cfi) == ref_regrid.control_span(cell, cfi)
    for sf in (0, 1, 5, 6):
        for port in range(cell.n_ports):
            assert regrid.crs_symbols(mine, port) == ref_regrid.crs_symbols(cell, port)
            np.testing.assert_array_equal(regrid.crs_positions(mine, port, sf),
                                          ref_regrid.crs_positions(cell, port, sf))
            np.testing.assert_array_equal(regrid.crs_values(mine, port, sf),
                                          ref_regrid.crs_values(cell, port, sf))
        for cfi in (1, 3):
            for start, n in ((0, cell.n_prb), (1, cell.n_prb // 2)):
                np.testing.assert_array_equal(regrid.pdsch_re(mine, sf, cfi, start, n),
                                              ref_regrid.pdsch_re(cell, sf, cfi, start, n))


@pytest.mark.parametrize("n_prb", [6, 25, 100])
@pytest.mark.parametrize("n_ports", [1, 2])
def test_pbch_positions_match_reference(n_prb, n_ports):
    for cell_id in (0, 42, 150, 503):  # every vshift class
        cell = Cell(n_prb=n_prb, cell_id=cell_id, n_ports=n_ports)
        pos = regrid.pbch_positions(_mine(cell))
        np.testing.assert_array_equal(pos, ref_regrid.pbch_positions(cell))
        assert pos.shape == (240, 2) and pos.dtype == np.int32
    ext = Cell(n_prb=n_prb, cell_id=7, n_ports=n_ports, extended_cp=True)
    np.testing.assert_array_equal(regrid.pbch_positions(_mine(ext)),
                                  ref_regrid.pbch_positions(ext))


def test_radio_copy_matches_reference(tmp_path):
    """The same reads, seeks, zero padding past the end, timestamps,
    `exhausted` and TX log from the port's radios and the reference's."""
    assert rnti.SI_RNTI == 0xFFFF and rnti.P_RNTI == 0xFFFE
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(np.complex64)
    path = tmp_path / "iq.bin"
    radio.write_iq(str(path), x.reshape(10, 100))
    ref_path = tmp_path / "iq_ref.bin"
    ref_radio.write_iq(str(ref_path), x.reshape(10, 100))
    assert path.read_bytes() == ref_path.read_bytes()
    pairs = [(radio.ArrayRadio(x, 1.92e6), ref_radio.ArrayRadio(x, 1.92e6)),
             (radio.FileRadio(str(path), 1.92e6), ref_radio.FileRadio(str(path), 1.92e6))]
    for mine, ref in pairs:
        for step in (("rx", 300), ("rx", 1), ("seek", 950), ("rx", 100), ("rx", 10),
                     ("seek", 0), ("rx", 0), ("rx", 1000), ("seek", 5000), ("rx", 3)):
            if step[0] == "seek":
                assert mine.seek(step[1]) is True and ref.seek(step[1]) is True
            else:
                (a, ta), (b, tb) = mine.rx_now(step[1]), ref.rx_now(step[1])
                np.testing.assert_array_equal(a, b)
                assert a.dtype == np.complex64 and len(a) == step[1] and ta == tb
            assert mine.pos == ref.pos and mine.exhausted == ref.exhausted
        mine.tx(x[:4], 0.5)
        ref.tx(x[:4], 0.5)
        assert mine.tx_log[0][0] == ref.tx_log[0][0] == 0.5
        np.testing.assert_array_equal(mine.tx_log[0][1], ref.tx_log[0][1])
    base = radio.Radio()
    assert base.seek(3) is False
    base.set_rx_srate(7.68e6)
    assert base.srate == 7.68e6
    for call in (lambda: base.rx_now(1), lambda: base.tx(x, 0.0)):
        with pytest.raises(NotImplementedError):
            call()


def test_grant_and_modulation_constants_match_reference():
    assert port_cell.NFFT_BY_PRB == ref_cell.NFFT_BY_PRB
    assert ((port_cell.MOD_BPSK, port_cell.MOD_QPSK, port_cell.MOD_16QAM, port_cell.MOD_64QAM)
            == (ref_cell.MOD_BPSK, ref_cell.MOD_QPSK, ref_cell.MOD_16QAM, ref_cell.MOD_64QAM))
    for cls in ("DlGrant", "UlGrant"):
        fields = [f.name for f in dataclasses.fields(getattr(ref_cell, cls))]
        assert [f.name for f in dataclasses.fields(getattr(port_cell, cls))] == fields
        g = getattr(port_cell, cls)(n_prb=4, prb_start=2, mcs=9, mod_order=2, tbs=904, rv=2)
        _same(g, getattr(ref_cell, cls)(**dataclasses.asdict(g)))
    with pytest.raises(ValueError):
        port_cell.Cell(n_prb=7)


@pytest.mark.parametrize("kind", ["24A", "24B", "16", "8"])
def test_crc_copy_matches_reference(kind):
    rng = np.random.default_rng(len(kind))
    for n in (1, 16, 40, 500, 6120):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        np.testing.assert_array_equal(crc.crc(bits, kind), ref_crc.crc(bits, kind))
        for mask in (0, 0x1234):
            np.testing.assert_array_equal(crc.attach(bits, kind, mask),
                                          ref_crc.attach(bits, kind, mask))
        np.testing.assert_array_equal(crc.crc_matrix(n, kind), ref_crc.crc_matrix(n, kind))
        word = crc.attach(bits, kind, 0x1234)
        for mask in (0, 0x1234):
            assert crc.check(word, kind, mask) == ref_crc.check(word, kind, mask) == bool(mask)


def test_seq_copy_and_bits_to_bytes_match_reference():
    for c_init in (0, 1, 0x1234 << 14, (1 << 31) - 1, 2 ** 10 * 7 * 85 + 84):
        for length in (1, 31, 440, 4 * 110, 15000):
            np.testing.assert_array_equal(seq.prs(c_init, length), ref_seq.prs(c_init, length))
            np.testing.assert_array_equal(seq.prs_f32(c_init, length),
                                          ref_seq.prs_f32(c_init, length))
    for n_id_2 in range(3):
        np.testing.assert_array_equal(seq.pss_freq(n_id_2), ref_seq.pss_freq(n_id_2))
        for n_id_1 in (0, 29, 30, 167):
            for sf5 in (False, True):
                np.testing.assert_array_equal(seq.sss_freq(n_id_1, n_id_2, sf5),
                                              ref_seq.sss_freq(n_id_1, n_id_2, sf5))
    rng = np.random.default_rng(3)
    for n in (8, 24, 904, 75376):
        bits = rng.integers(0, 2, n).astype(np.uint8)
        assert pdu.bits_to_bytes(bits) == ref_pdu.bits_to_bytes(bits)
