"""Host tables of the torch port against the JAX reference: TBS, grants,
segmentation, QPP, trellis, turbo encoder, rate-matching maps and the
PdschCodec tables. All comparisons are exact (integer tables)."""

import numpy as np
import pytest

from srsue_tpu.phy import pdsch as ref_pdsch
from srsue_tpu.phy import ra as ref_ra
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy import segmentation as ref_seg
from srsue_tpu.phy import turbo as ref_turbo
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.phy import pdsch, ra, ratematch, segmentation, turbo


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
            assert ra.dl_grant(n_prb, mcs, rv=rv) == ref_ra.dl_grant(n_prb, mcs, rv=rv)
    assert ra.dl_grant(n_prb, 10, n_prb_alloc=3, prb_start=2) == \
        ref_ra.dl_grant(n_prb, 10, n_prb_alloc=3, prb_start=2)


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
    mine = pdsch.PdschCodec(cell, grant, rnti=0x1234, subframe=subframe, cfi=1)
    rt = pdsch.PdschCodec.from_arrays(
        cell, grant, ref.re_idx, ref.rm_idx, ref.scr_pm1, ref._blk_crc,
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
