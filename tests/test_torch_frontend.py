"""Receive front end of the torch port against the JAX reference: OFDM
demodulation, CRS channel estimation (flat and multipath, so that every
pilot-filter pick occurs), ZF/MMSE equalization and max-log demapping.

Tolerances: complex64 results are held to rtol 1e-5 with an absolute
floor of 1e-5 of the array's peak magnitude (FFT and matmul sums are taken
in another order than XLA's, so small elements carry the rounding of large
ones). LLRs: rtol 1e-4 with a floor of 1e-4 of the peak, because a
difference of squared distances divided by a small noise variance
amplifies that input rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import chest as ref_chest
from srsue_tpu.phy import equalize as ref_eq
from srsue_tpu.phy import modulation as ref_mod
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.phy import chest, enb_tx, equalize, modulation, ofdm


def _close(got, ref, rtol=1e-5, floor=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * np.abs(ref).max())


def _grid_with_data(cell, subframe, rng):
    grid = enb_tx.empty_grid(cell)
    enb_tx.add_crs(cell, grid, subframe, 0)
    empty = grid == 0
    grid[empty] = ((rng.integers(0, 2, empty.sum()) * 2 - 1)
                   + 1j * (rng.integers(0, 2, empty.sum()) * 2 - 1)) / np.sqrt(2)
    return grid


@pytest.mark.parametrize("n_prb", [6, 25])
def test_ofdm_roundtrip_matches_reference(n_prb):
    cell = Cell(n_prb=n_prb, cell_id=11)
    rng = np.random.default_rng(n_prb)
    grids = np.stack([_grid_with_data(cell, 2, rng) for _ in range(2)])
    td = ofdm.modulate_np(cell, grids)
    np.testing.assert_array_equal(td, ref_ofdm.modulate_np(cell, grids))
    noisy, _ = enb_tx.awgn(rng, td, 15.0)
    got = ofdm.demodulate(cell, torch.as_tensor(noisy))
    _close(got.numpy(), ref_ofdm.demodulate(cell, jnp.asarray(noisy)))


def _faded_grids(cell, subframe, channels, rng):
    """One noisy received grid per (taps, snr_db)."""
    half = cell.n_sc // 2
    bins = np.concatenate([np.arange(cell.nfft - half, cell.nfft), np.arange(1, half + 1)])
    out = []
    for taps, snr_db in channels:
        taps = np.asarray(taps, np.complex64)
        taps /= np.sqrt(np.sum(np.abs(taps) ** 2))
        grid = _grid_with_data(cell, subframe, rng) * np.fft.fft(taps, cell.nfft)[bins]
        sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
        out.append(grid + sigma * (rng.standard_normal(grid.shape)
                                   + 1j * rng.standard_normal(grid.shape)))
    return np.stack(out).astype(np.complex64)


def test_chest_matches_reference_and_covers_every_filter_pick():
    cell = Cell(n_prb=25, cell_id=31)
    subframe = 2
    mid = np.zeros(9)
    mid[[0, 8]] = 1.0, 0.6
    long_ = np.zeros(64)
    long_[[0, 40]] = 1.0, 0.8
    two_tap = np.zeros(4)
    two_tap[[0, 3]] = 1.0, 0.5
    channels = [([1.0], 10.0), (mid, 12.0), (long_, 20.0), (two_tap, 25.0), ([1.0], 30.0)]
    grids = _faded_grids(cell, subframe, channels, np.random.default_rng(0))

    h, nvar, rsrp = chest.estimate(cell, torch.as_tensor(grids), subframe)
    h_r, nvar_r, rsrp_r = ref_chest.estimate(cell, jnp.asarray(grids), subframe)
    _close(h.numpy(), h_r)
    _close(nvar.numpy(), nvar_r)
    _close(rsrp.numpy(), rsrp_r)

    # the adaptive pilot filter picked raw, 3-tap and 5-tap across the batch
    h_sym = chest.pilot_ls(cell, torch.as_tensor(grids), subframe)
    _, pick = chest._pilot_filter(h_sym, nvar, float(h_sym.shape[-2]))
    assert set(pick.tolist()) == {0, 3, 5}, pick

    m = chest.metrics(cell, torch.as_tensor(grids), nvar, rsrp)
    m_r = ref_chest.metrics(cell, jnp.asarray(grids), nvar_r, rsrp_r)
    for key, val in m.items():
        np.testing.assert_allclose(val.numpy(), np.asarray(m_r[key]), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("name", ["zf", "mmse"])
def test_equalizers_match_reference(name):
    rng = np.random.default_rng(3)
    shape = (3, 500)
    y = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    h = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    h[0, :5] = 1e-4  # deep fades
    nv = np.array([0.01, 0.1, 1.0], np.float32)
    x, nve = getattr(equalize, name)(torch.as_tensor(y), torch.as_tensor(h), torch.as_tensor(nv))
    x_r, nve_r = getattr(ref_eq, name)(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    _close(x.numpy(), x_r)
    _close(nve.numpy(), nve_r)


@pytest.mark.parametrize("qm", [2, 4, 6])
def test_soft_demap_matches_reference(qm):
    rng = np.random.default_rng(qm)
    bits = rng.integers(0, 2, (2, 300 * qm)).astype(np.uint8)
    sym = modulation.modulate_np(bits, qm)
    np.testing.assert_array_equal(sym, ref_mod.modulate_np(bits, qm))
    np.testing.assert_array_equal(modulation.constellation(qm), ref_mod.constellation(qm))
    y = (sym + 0.1 * (rng.standard_normal(sym.shape) + 1j * rng.standard_normal(sym.shape))
         ).astype(np.complex64)
    nv = (0.01 + rng.random(sym.shape)).astype(np.float32)
    got = modulation.demodulate_soft(torch.as_tensor(y), qm, torch.as_tensor(nv))
    ref = ref_mod.demodulate_soft(jnp.asarray(y), qm, jnp.asarray(nv))
    _close(got.numpy(), ref, rtol=1e-4, floor=1e-4)
    np.testing.assert_array_equal(got.numpy() < 0, np.asarray(ref) < 0)
    scalar = modulation.demodulate_soft(torch.as_tensor(y), qm, 0.5)
    _close(scalar.numpy(), ref_mod.demodulate_soft(jnp.asarray(y), qm, 0.5),
           rtol=1e-4, floor=1e-4)
