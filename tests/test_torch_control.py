"""The port's control region (phy/control.py, the conv rate matching) against
the JAX reference: host tables and encoders equal element for element at
every bandwidth and CFI; PCFICH and PDCCH blind-search decisions (CFI,
candidate hard bits, CRC pass) equal on the same noisy subframes. The
equalized grids the two front ends produce agree to float32 rounding
(test_torch_frontend.py), so the decisions are compared, and the
reference's own equalized grid is also fed to the port's decoders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import chest as ref_chest
from srsue_tpu.phy import control as ref_control
from srsue_tpu.phy import enb_tx as ref_tx
from srsue_tpu.phy import equalize as ref_eq
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.phy import chest, control, equalize, ofdm, ratematch

BANDWIDTHS = (6, 15, 25, 50, 75, 100)


@pytest.mark.parametrize("n_prb", BANDWIDTHS)
def test_geometry_and_encoders_match_reference(n_prb):
    rng = np.random.default_rng(n_prb)
    for cfi in (1, 2, 3):
        cell = Cell(n_prb=n_prb, cell_id=(37 * n_prb + 11 * cfi) % 504)
        for l in range(4):
            assert control.regs_in_symbol(cell, l) == ref_control.regs_in_symbol(cell, l)
        assert control.pcfich_regs(cell) == ref_control.pcfich_regs(cell)
        assert control.n_phich_groups(cell) == ref_control.n_phich_groups(cell)
        assert control.phich_reg_table(cell) == ref_control.phich_reg_table(cell)
        n_cce, cce_re = control.pdcch_geometry(cell, cfi)
        ref_n, ref_re = ref_control.pdcch_geometry(cell, cfi)
        assert n_cce == ref_n
        np.testing.assert_array_equal(cce_re, ref_re)
        for sf in (0, 6):
            np.testing.assert_array_equal(control.pcfich_encode(cell, sf, cfi),
                                          ref_control.pcfich_encode(cell, sf, cfi))
        for rnti, sf, ue in ((0x1234, 6, True), (0xFFFF, 0, True), (0x4601, 9, False)):
            assert (control.search_space_candidates(n_cce, rnti, sf, ue)
                    == ref_control.search_space_candidates(n_cce, rnti, sf, ue))
        dci_bits = rng.integers(0, 2, 27).astype(np.uint8)
        for l_aggr in (1, 2, 4, 8):
            np.testing.assert_array_equal(
                control.pdcch_encode(cell, 6, dci_bits, 0x1234, l_aggr),
                ref_control.pdcch_encode(cell, 6, dci_bits, 0x1234, l_aggr))
        l_aggr = 4 if n_cce >= 4 else 1
        grids = [ref_tx.empty_grid(cell) for _ in range(2)]
        control.pcfich_map(cell, grids[0], 6, cfi)
        control.pdcch_map(cell, grids[0], 6, cfi, dci_bits, 0x1234, 0, l_aggr)
        ref_control.pcfich_map(cell, grids[1], 6, cfi)
        ref_control.pdcch_map(cell, grids[1], 6, cfi, dci_bits, 0x1234, 0, l_aggr)
        np.testing.assert_array_equal(grids[0], grids[1])


@pytest.mark.parametrize("k", [31, 40, 44, 54, 57])
def test_conv_rate_matching_matches_reference(k):
    for e in (72, 144, 288, 576):
        np.testing.assert_array_equal(ratematch.conv_rm_indices(k, e),
                                      ref_rm.conv_rm_indices(k, e))


def _control_subframes(cell, sf, cfi, rnti, dci_len, placements, snr_db, seed):
    """Two noisy subframes of CRS + PCFICH + one DCI per (start, L) in
    placements, each with its own random payload; returns (iq, payloads)."""
    rng = np.random.default_rng(seed)
    tds, pays = [], []
    for _ in range(2):
        grid = ref_tx.empty_grid(cell)
        ref_tx.add_crs(cell, grid, sf, 0)
        ref_control.pcfich_map(cell, grid, sf, cfi)
        bits = [rng.integers(0, 2, dci_len).astype(np.uint8) for _ in placements]
        for b, (start, l) in zip(bits, placements):
            ref_control.pdcch_map(cell, grid, sf, cfi, b, rnti, start, l)
        tds.append(ref_tx.to_waveform(cell, [grid])[0])
        pays.append(bits)
    td = np.stack(tds)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return ref_tx.awgn(rng, td, snr_db, signal_power=p_sig)[0], pays


CASES = {  # n_prb, cell_id, subframe, cfi, rnti, dci_len, snr_db, DCI placements
    "6prb_cfi3": (6, 17, 1, 3, 0x1234, 21, 8.0, [(0, 4), (4, 2)]),
    "25prb_cfi1": (25, 301, 6, 1, 0x4601, 27, 6.0, [(0, 2), (2, 1)]),
    "25prb_cfi3": (25, 99, 3, 3, 0x5A5A, 27, 4.0, [(0, 4), (10, 2)]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pcfich_and_blind_search_match_reference(name):
    n_prb, cell_id, sf, cfi, rnti, dci_len, snr, placements = CASES[name]
    cell = Cell(n_prb=n_prb, cell_id=cell_id)
    n_cce, _ = control.pdcch_geometry(cell, cfi)
    cands = control.search_space_candidates(n_cce, rnti, sf)
    iq, pays = _control_subframes(cell, sf, cfi, rnti, dci_len, placements, snr, n_prb)

    g_r = ref_ofdm.demodulate(cell, jnp.asarray(iq))
    h_r, nv_r, _ = ref_chest.estimate(cell, g_r, sf, port=0)
    ge_r, nve_r = ref_eq.zf(g_r, h_r, nv_r)
    cfi_r, sc_r = ref_control.pcfich_decode(cell, ge_r, nve_r, sf)
    hard_r, ok_r = (np.asarray(v) for v in ref_control.pdcch_blind_batch(
        cell, ge_r, nve_r, sf, cfi, rnti, dci_len))

    g = ofdm.demodulate(cell, torch.as_tensor(iq))
    h, nv, _ = chest.estimate(cell, g, sf, port=0)
    ge, nve = equalize.zf(g, h, nv)
    cfi_p, sc_p = control.pcfich_decode(cell, ge, nve, sf)
    hard, ok = control.pdcch_blind_batch(cell, ge, nve, sf, cfi, rnti, dci_len)

    np.testing.assert_array_equal(cfi_p.numpy(), np.asarray(cfi_r))
    assert (cfi_p.numpy() == cfi).all()
    sc_r = np.asarray(sc_r)
    np.testing.assert_allclose(sc_p.numpy(), sc_r, rtol=1e-4, atol=1e-4 * np.abs(sc_r).max())
    np.testing.assert_array_equal(hard.numpy(), hard_r)
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    for b in range(2):  # both DCIs found, on their own candidates
        for bits, c in zip(pays[b], placements):
            i = cands.index(c)
            assert ok[b, i] and (hard[b, i].numpy() == bits).all()
        hits = control.blind_hits(cands, hard[b].numpy(), ok[b].numpy(), dci_len)
        assert sorted(h[2].tobytes() for h in hits) == sorted(p.tobytes() for p in pays[b])

    # the reference's own equalized grid through the port's decoders
    same = control.pdcch_blind_batch(cell, torch.as_tensor(np.array(ge_r)),
                                     torch.as_tensor(np.array(nve_r)), sf, cfi, rnti,
                                     dci_len)
    np.testing.assert_array_equal(same[0].numpy(), hard_r)
    np.testing.assert_array_equal(same[1].numpy(), ok_r)
    # one subframe alone, and the host-side decode
    one = control.pdcch_blind_batch(cell, ge[1], nve[1], sf, cfi, rnti, dci_len)
    np.testing.assert_array_equal(one[0].numpy(), hard[1].numpy())
    got = control.pdcch_blind_decode(cell, ge[0], nve[0], sf, cfi, rnti, dci_len)
    assert sorted(b.tobytes() for _, _, b in got) == sorted(p.tobytes() for p in pays[0])

    # a wrong RNTI: no false alarm (common candidates still searched)
    _, ok_wrong = control.pdcch_blind_batch(cell, ge, nve, sf, cfi, rnti ^ 0x0101, dci_len)
    assert not ok_wrong.any()


def test_batch_shaped_noise_broadcasts():
    """A [B] noise (one value per subframe) gives what the same value spread
    over the grid gives, for PCFICH and the blind search."""
    n_prb, cell_id, sf, cfi, rnti, dci_len, snr, placements = CASES["25prb_cfi3"]
    cell = Cell(n_prb=n_prb, cell_id=cell_id)
    iq, _ = _control_subframes(cell, sf, cfi, rnti, dci_len, placements[:1], snr, 3)
    g = ofdm.demodulate(cell, torch.as_tensor(iq))
    h, nv, _ = chest.estimate(cell, g, sf, port=0)
    ge, _ = equalize.zf(g, h, nv)
    grid_nv = nv[:, None, None].expand(ge.shape).contiguous()
    for a, b in zip(control.pcfich_decode(cell, ge, nv, sf),
                    control.pcfich_decode(cell, ge, grid_nv, sf)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(control.pdcch_blind_batch(cell, ge, nv, sf, cfi, rnti, dci_len),
                    control.pdcch_blind_batch(cell, ge, grid_nv, sf, cfi, rnti, dci_len)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert control.pdcch_blind_batch(cell, ge, nv, sf, cfi, rnti, dci_len)[1][:, 0].all()


def test_empty_search_space_raises():
    cell = Cell(n_prb=6, cell_id=1)
    ge = torch.zeros(cell.n_sym_sf, cell.n_sc, dtype=torch.complex64)
    with pytest.raises(ValueError, match="empty search space"):
        control.pdcch_blind_batch(cell, ge, 1.0, 1, 1, 0, 21, ue_specific=False)
