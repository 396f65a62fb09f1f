"""Host tables of the torch port against the JAX reference: TBS, grants,
segmentation, QPP, trellis, turbo encoder, rate-matching maps and the
PdschCodec tables. All comparisons are exact (integer tables)."""

import dataclasses

import numpy as np
import pytest

from srsue_tpu.mac import pdu as ref_pdu
from srsue_tpu.phy import cell as ref_cell
from srsue_tpu.phy import crc as ref_crc
from srsue_tpu.phy import pdsch as ref_pdsch
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy import regrid as ref_regrid
from srsue_tpu.phy import segmentation as ref_seg
from srsue_tpu.phy import seq as ref_seq
from srsue_tpu.phy import turbo as ref_turbo
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.mac import pdu
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import crc, pdsch, ra, ratematch, regrid, segmentation, seq, turbo


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
    rng = np.random.default_rng(0)
    for tbs in (500, 7736, 14112):
        bits = rng.integers(0, 2, tbs).astype(np.uint8)
        for a, b in zip(segmentation.segment(bits), ref_seg.segment(bits), strict=True):
            np.testing.assert_array_equal(a, b)


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


def test_seq_copy_and_bits_to_bytes_match_reference():
    for c_init in (0, 1, 0x1234 << 14, (1 << 31) - 1, 2 ** 10 * 7 * 85 + 84):
        for length in (1, 31, 440, 4 * 110, 15000):
            np.testing.assert_array_equal(seq.prs(c_init, length), ref_seq.prs(c_init, length))
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
