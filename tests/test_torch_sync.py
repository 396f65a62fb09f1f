"""Cell search of the torch port (phy/sync.py) against the JAX reference on
the same seeded waveforms: PSS correlation and peak pick, CP-based CFO
estimate and correction, SSS identification and the decimating FIR.

Exact: the host tables, the detected root, the peak's sample index, N_id_1
and the half-frame flag. The reference transforms through its matmul DFT
and the port through torch.fft, which sum in another order: correlation
magnitudes, CFO, SSS scores and filtered samples are float32 results held
to rtol 1e-4 with an absolute floor of 1e-4 of the array's peak.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import enb_tx as ref_enb_tx
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu.phy import pbch as ref_pbch
from srsue_tpu.phy import regrid as ref_regrid
from srsue_tpu.phy import sync as ref_sync
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import ofdm, sync


def _mine(cell):
    return port_cell.Cell(**dataclasses.asdict(cell))


def _close(got, ref, rtol=1e-4, floor=1e-4):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * np.abs(ref).max())


def _sf0_waveform(cell, mib_sfn=0, snr_db=20, seed=0, cfo=0.0, subframe=0):
    """Subframe 0 (or 5) with CRS, PSS/SSS and, in subframe 0, the PBCH, with
    a CFO and AWGN (tests/test_sync_pbch.py's)."""
    rng = np.random.default_rng(seed)
    grid = ref_enb_tx.empty_grid(cell)
    ref_enb_tx.add_crs(cell, grid, subframe, 0)
    ref_enb_tx.add_sync(cell, grid, subframe)
    if subframe == 0:
        cw = ref_pbch.encode(cell, ref_pbch.Mib(cell.n_prb, "normal", 1.0, mib_sfn), n_ports=1)
        ref_pbch.map_to_grid(cell, grid, ref_pbch.frame_symbols(cell, cw, mib_sfn % 4))
    td = ref_ofdm.modulate_np(cell, grid)
    if cfo:
        td = td * np.exp(2j * np.pi * cfo * np.arange(len(td)) / cell.nfft)
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return ref_enb_tx.awgn(rng, td, snr_db, signal_power=p_sig)[0]


def test_host_tables_match_reference():
    for r in range(3):
        np.testing.assert_array_equal(sync.pss_time_replica(r), ref_sync.pss_time_replica(r))
        np.testing.assert_array_equal(sync.pss_time_replica(r, 256),
                                      ref_sync.pss_time_replica(r, 256))
    np.testing.assert_array_equal(sync._sss_bank(), ref_sync._sss_bank())
    for decim in (1, 2, 4, 8, 16):
        np.testing.assert_array_equal(sync._lpf_taps(decim), ref_sync._lpf_taps(decim))
    assert sync.SEARCH_NFFT == ref_sync.SEARCH_NFFT


@pytest.mark.parametrize("cell_id", [0, 127, 503])
def test_pss_correlation_and_peak_match_reference(cell_id):
    cell = Cell(n_prb=6, cell_id=cell_id)
    td = _sf0_waveform(cell, snr_db=10, seed=cell_id)
    c = sync.pss_correlate(torch.as_tensor(td))
    c_r = ref_sync.pss_correlate(jnp.asarray(td))
    assert c.dtype == torch.float32
    _close(c.numpy(), c_r)
    nid2, t, peak = sync.find_pss(torch.as_tensor(td))
    nid2_r, t_r, peak_r = ref_sync.find_pss(jnp.asarray(td))
    assert (int(nid2), int(t)) == (int(nid2_r), int(t_r))
    assert int(nid2) == cell.n_id_2
    assert abs(int(t) - ofdm.symbol_starts(_mine(cell))[cell.n_sym_slot - 1]) <= 2
    np.testing.assert_allclose(float(peak), float(peak_r), rtol=1e-4)


def test_batched_search_over_half_frames_matches_reference():
    """[n_halves, half_len] segments, as cell_search batches them."""
    cell = Cell(n_prb=6, cell_id=301)
    segs = np.stack([_sf0_waveform(cell, snr_db=8, seed=s, subframe=sf)
                     for s, sf in ((1, 0), (2, 5), (3, 0))])
    got = sync.find_pss(torch.as_tensor(segs))
    ref = ref_sync.find_pss(jnp.asarray(segs))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4)
    assert got[0].tolist() == [cell.n_id_2] * 3


def test_cfo_estimate_and_correction_match_reference():
    cell = Cell(n_prb=6, cell_id=301)
    td = _sf0_waveform(cell, snr_db=0, seed=7, cfo=0.31)
    nid2, t, _ = sync.find_pss(torch.as_tensor(td))
    nid2_r, t_r, _ = ref_sync.find_pss(jnp.asarray(td))
    assert (int(nid2), int(t)) == (int(nid2_r), int(t_r)) and int(nid2) == cell.n_id_2
    cp = cell.cp_lengths[1]
    seg = td[int(t) - cp: int(t) + cell.nfft]
    cfo = sync.cfo_estimate_cp(torch.as_tensor(seg), cell.nfft, cp)
    cfo_r = ref_sync.cfo_estimate_cp(jnp.asarray(seg), cell.nfft, cp)
    np.testing.assert_allclose(float(cfo), float(cfo_r), rtol=1e-4, atol=1e-6)
    assert abs(float(cfo) - 0.31) < 0.05
    for c in (float(cfo_r), np.float32(-0.22)):
        fixed = sync.cfo_correct(torch.as_tensor(td), c, cell.nfft)
        assert fixed.dtype == torch.complex64
        # the phase reaches 2 pi 0.31 x 15 symbols: float32 cos/sin of an
        # argument of ~30 rad differ by ~1e-6 between the two libraries
        _close(fixed.numpy(), ref_sync.cfo_correct(jnp.asarray(td), c, cell.nfft),
               rtol=1e-4, floor=1e-5)
    batch = torch.as_tensor(np.stack([td, td[::-1].copy()]))
    both = sync.cfo_correct(batch, torch.tensor([0.1, -0.2]), cell.nfft)
    _close(both.numpy(), ref_sync.cfo_correct(jnp.asarray(batch.numpy()),
                                              jnp.asarray([0.1, -0.2]), cell.nfft),
           rtol=1e-4, floor=1e-5)


@pytest.mark.parametrize("cell_id,sf5", [(17, False), (250, True), (502, False)])
def test_sss_identification_matches_reference(cell_id, sf5):
    cell = Cell(n_prb=6, cell_id=cell_id)
    sf = 5 if sf5 else 0
    noisy = _sf0_waveform(cell, snr_db=5, seed=3, subframe=sf)
    g = np.array(ref_ofdm.demodulate(cell, jnp.asarray(noisy)))
    sc = ref_regrid.sync_sc(cell)
    pss_fd = g[ref_regrid.pss_symbol(cell), sc[0]: sc[0] + 62]
    sss_fd = g[ref_regrid.sss_symbol(cell), sc[0]: sc[0] + 62]
    for fn in ("sss_coherent", "sss_identify"):
        args = (pss_fd, sss_fd) if fn == "sss_coherent" else (sss_fd,)
        nid1, got_sf5, score = getattr(sync, fn)(*(torch.as_tensor(a) for a in args),
                                                 cell.n_id_2)
        nid1_r, sf5_r, score_r = getattr(ref_sync, fn)(*(jnp.asarray(a) for a in args),
                                                       cell.n_id_2)
        assert (int(nid1), bool(got_sf5)) == (int(nid1_r), bool(sf5_r))
        np.testing.assert_allclose(float(score), float(score_r), rtol=1e-4)
    assert int(nid1) == cell.n_id_1 and bool(got_sf5) == sf5  # the coherent form's


def test_decimate_matches_reference_and_preserves_pss():
    """A 10 MHz capture decimated 8x to the search rate: the strided
    correlation gives the reference's stacked-copies product at the same
    output positions, and the PSS root and timing survive."""
    cell = Cell(n_prb=50, cell_id=99)
    td = _sf0_waveform(cell, snr_db=10, seed=1)
    decim = cell.nfft // sync.SEARCH_NFFT
    low = sync.decimate(torch.as_tensor(td), decim)
    low_r = ref_sync.decimate(jnp.asarray(td), decim)
    assert low.dtype == torch.complex64
    _close(low.numpy(), low_r, rtol=1e-4, floor=1e-5)
    nid2, t, _ = sync.find_pss(low)
    nid2_r, t_r, _ = ref_sync.find_pss(low_r)
    assert (int(nid2), int(t)) == (int(nid2_r), int(t_r)) and int(nid2) == cell.n_id_2
    cell6 = _mine(Cell(n_prb=6, cell_id=cell.cell_id))
    assert abs(int(t) - ofdm.symbol_starts(cell6)[cell6.n_sym_slot - 1]) <= 3


@pytest.mark.parametrize("n,decim", [(1000, 4), (1001, 4), (1003, 4), (96, 16), (500, 1)])
def test_decimate_lengths_and_batches(n, decim):
    """Lengths that are no multiple of the factor, and leading batch axes."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal((2, 3, n)) + 1j * rng.standard_normal((2, 3, n))
         ).astype(np.complex64)
    got = sync.decimate(torch.as_tensor(x), decim)
    ref = ref_sync.decimate(jnp.asarray(x), decim)
    assert got.shape == (2, 3, -(-n // decim))
    _close(got.numpy(), ref, rtol=1e-4, floor=1e-5)
