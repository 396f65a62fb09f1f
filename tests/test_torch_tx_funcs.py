"""The last public PHY functions of the reference, against their ports:
``modulation.modulate`` / ``demodulate_hard``, ``ofdm.modulate`` /
``demodulate_np``, ``ratematch.match``, ``convcode.encode_jax`` (the port's
``encode_torch``), ``segmentation.desegment`` / ``SegPlan.uniform_k`` and
``seq.prs_f32``, on the same seeded numpy inputs. Tolerances: exact for
bits, symbols of the mapper, gathers, codewords and tables; ``ofdm.modulate``
within 1e-5 of the waveform's peak (float32 FFTs of two libraries).

Also the reference's cases of ``tests/test_coding.py`` and
``tests/test_modulation_ofdm.py`` that use these functions, on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import cell as ref_cell
from srsue_tpu.phy import convcode as ref_convcode
from srsue_tpu.phy import modulation as ref_modulation
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy import segmentation as ref_seg
from srsue_tpu.phy import seq as ref_seq
from srsue_tpu_torch.phy import convcode, modulation, ofdm, ratematch, segmentation, seq, turbo
from srsue_tpu_torch.phy.cell import MOD_16QAM, MOD_64QAM, MOD_BPSK, MOD_QPSK, Cell

ORDERS = (MOD_BPSK, MOD_QPSK, MOD_16QAM, MOD_64QAM)
SOFT_ORDERS = (MOD_QPSK, MOD_16QAM, MOD_64QAM)  # BPSK has no demapper in either


def t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------------------------------------- modulation
@pytest.mark.parametrize("m", ORDERS)
def test_modulate_equals_the_reference(m):
    bits = np.random.default_rng(m).integers(0, 2, (3, 40 * m)).astype(np.uint8)
    got = modulation.modulate(t(bits), m)
    assert got.dtype == torch.complex64 and got.shape == (3, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_modulation.modulate(
        jnp.asarray(bits), m)))
    np.testing.assert_array_equal(got.numpy(), modulation.modulate_np(bits, m))


def _boundary_symbols(m):
    """Symbols on every slicer boundary of the order's PAM (0 and the
    midpoints between adjacent levels), on I, Q and both."""
    lv = np.sort(ref_modulation._pam_levels(m)[0].astype(np.float64))
    edges = np.concatenate([[0.0], (lv[1:] + lv[:-1]) / 2])
    pts = np.concatenate([edges, lv])
    i, q = np.meshgrid(pts, pts)
    return (i + 1j * q).astype(np.complex64).ravel()


@pytest.mark.parametrize("m", SOFT_ORDERS)
def test_demodulate_hard_equals_the_reference_with_its_tie_rule(m):
    rng = np.random.default_rng(10 + m)
    sym = (rng.standard_normal((4, 64)) + 1j * rng.standard_normal((4, 64))).astype(
        np.complex64)
    edge = _boundary_symbols(m)
    for y in (sym, edge):
        got = modulation.demodulate_hard(t(y), m)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            ref_modulation.demodulate_hard(jnp.asarray(y), m)))
    # on the sign boundaries (the sign bits' LLR is 0) both sign bits are 0
    zero = modulation.demodulate_hard(torch.zeros(1, dtype=torch.complex64), m)
    assert zero.tolist()[:2] == [0, 0]


def test_bpsk_has_no_demapper_in_either():
    for fn in (lambda: modulation.demodulate_hard(torch.zeros(2, dtype=torch.complex64), 1),
               lambda: ref_modulation.demodulate_hard(jnp.zeros(2, jnp.complex64), 1)):
        with pytest.raises(ValueError):
            fn()


@pytest.mark.parametrize("m", SOFT_ORDERS)
def test_mod_demod_roundtrip_noiseless(m):
    """``test_modulation_ofdm.py::test_mod_demod_roundtrip_noiseless``."""
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 8 * 120 * m).astype(np.uint8).reshape(8, -1)
    hard = modulation.demodulate_hard(modulation.modulate(t(bits), m), m)
    np.testing.assert_array_equal(hard.numpy(), bits)


@pytest.mark.parametrize("m", SOFT_ORDERS)
def test_soft_llr_sign_and_scaling(m):
    """``test_modulation_ofdm.py::test_soft_llr_sign_and_scaling``."""
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 600 * m).astype(np.uint8)
    sym = modulation.modulate(t(bits), m).numpy()
    noisy = (sym + 0.02 * (rng.standard_normal(sym.shape)
                           + 1j * rng.standard_normal(sym.shape))).astype(np.complex64)
    llr = modulation.demodulate_soft(t(noisy), m, noise_var=2 * 0.02 ** 2).numpy()
    assert llr.shape == (600 * m,)
    assert ((llr < 0).astype(np.uint8) == bits).mean() > 0.99
    llr2 = modulation.demodulate_soft(t(noisy), m, noise_var=0.02 ** 2).numpy()
    assert np.mean(np.abs(llr2)) > 1.5 * np.mean(np.abs(llr))


# ------------------------------------------------------------------- OFDM
@pytest.mark.parametrize("n_prb", [6, 25, 100])
def test_ofdm_modulate_equals_the_reference(n_prb):
    cell = Cell(n_prb=n_prb, cell_id=1)
    rng = np.random.default_rng(5)
    grid = (rng.standard_normal((2, cell.n_sym_sf, cell.n_sc))
            + 1j * rng.standard_normal((2, cell.n_sym_sf, cell.n_sc))).astype(np.complex64)
    got = ofdm.modulate(cell, t(grid))
    assert got.dtype == torch.complex64 and got.shape == (2, cell.sf_len)
    ref = np.asarray(ref_ofdm.modulate(ref_cell.Cell(n_prb=n_prb, cell_id=1),
                                       jnp.asarray(grid)))
    peak = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * peak)
    np.testing.assert_allclose(got.numpy(), ofdm.modulate_np(cell, grid), rtol=0,
                               atol=1e-5 * peak)
    # it inverts the port's demodulator (test_modulation_ofdm.py::test_ofdm_roundtrip)
    np.testing.assert_allclose(ofdm.demodulate(cell, got).numpy(), grid, atol=1e-3)
    np.testing.assert_allclose(ofdm.demodulate_np(cell, got.numpy()), grid, atol=1e-3)


def test_ofdm_modulate_scaling_and_dc_placement():
    """One unit subcarrier either side of DC: unitary scaling (the energy of
    a symbol's data part is 1), grid index n_sc/2 at bin +1 and n_sc/2 - 1 at
    bin -1, as the reference places them."""
    cell = Cell(n_prb=6, cell_id=1)
    half, nfft = cell.n_sc // 2, cell.nfft
    for k, bin_ in ((half, 1), (half - 1, nfft - 1)):
        grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
        grid[0, k] = 1.0
        td = ofdm.modulate(cell, t(grid)).numpy()
        cp = cell.cp_lengths[0]
        body = td[cp:cp + nfft]
        assert np.sum(np.abs(body) ** 2) == pytest.approx(1.0, abs=1e-5)
        n = np.arange(nfft)
        np.testing.assert_allclose(body, np.exp(2j * np.pi * bin_ * n / nfft) / np.sqrt(nfft),
                                   atol=1e-6)
        ref = np.asarray(ref_ofdm.modulate(ref_cell.Cell(n_prb=6, cell_id=1), jnp.asarray(grid)))
        np.testing.assert_allclose(td, ref, atol=1e-6)


def test_ofdm_cp_is_cyclic():
    """``test_modulation_ofdm.py::test_ofdm_cp_is_cyclic``."""
    cell = Cell(n_prb=6)
    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    grid[0, 3] = 1.0
    td = ofdm.modulate(cell, t(grid)).numpy()
    cp0 = cell.cp_lengths[0]
    np.testing.assert_allclose(td[:cp0], td[cell.nfft:cp0 + cell.nfft], atol=1e-6)


@pytest.mark.parametrize("n_prb", [6, 25])
def test_demodulate_np_equals_the_reference(n_prb):
    cell = Cell(n_prb=n_prb, cell_id=3)
    x = np.random.default_rng(n_prb).standard_normal((2, cell.sf_len)).astype(np.complex64)
    np.testing.assert_array_equal(ofdm.demodulate_np(cell, x), ref_ofdm.demodulate_np(
        ref_cell.Cell(n_prb=n_prb, cell_id=3), x))


# ------------------------------------------------------- rate match, codes
@pytest.mark.parametrize("k,e,rv", [(40, 100, 0), (512, 700, 0), (512, 2100, 2), (6144, 5000, 3)])
def test_turbo_match_equals_the_reference_and_roundtrips(k, e, rv):
    """``test_coding.py::test_turbo_rm_roundtrip`` on the port, with the
    gather held to the reference's exactly."""
    rng = np.random.default_rng(7)
    b = rng.integers(0, 2, k).astype(np.uint8)
    d = turbo.encode(b)
    d_flat = d.reshape(-1).astype(np.float32)
    idx = ratematch.turbo_rm_indices(k + 4, e, rv)
    tx = ratematch.match(t(d_flat), idx)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(ref_rm.match(jnp.asarray(d_flat), idx)))
    np.testing.assert_array_equal(ratematch.match(t(d_flat), t(idx)).numpy(), tx.numpy())
    soft = 1.0 - 2.0 * tx
    w = ratematch.dematch(soft, t(ratematch.inverse_index(idx, 3 * (k + 4))))
    hard, _, _ = turbo.decode(w.reshape(1, 3, k + 4), k, n_iters=6)
    if e >= 3 * k:  # enough bits for a reliable decode
        np.testing.assert_array_equal(hard.numpy()[0], b)


def test_conv_match_equals_the_reference_and_roundtrips():
    """``test_coding.py::test_conv_rm_roundtrip`` on the port."""
    rng = np.random.default_rng(8)
    n = 40
    m = rng.integers(0, 2, n).astype(np.uint8)
    c = convcode.encode(m).reshape(-1).astype(np.float32)
    idx = ratematch.conv_rm_indices(n, 120)
    tx = ratematch.match(t(c), idx)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(ref_rm.match(jnp.asarray(c), idx)))
    w = ratematch.dematch(1.0 - 2.0 * tx, t(ratematch.inverse_index(idx, 3 * n))).reshape(3, n)
    np.testing.assert_array_equal(convcode.decode(w.T[None].contiguous()).numpy()[0], m)


@pytest.mark.parametrize("n", [40, 64, 96])
def test_encode_torch_equals_encode_jax_and_the_host_encoder(n):
    """``test_coding.py::test_conv_encode_jax_matches_numpy`` on the port."""
    msgs = np.random.default_rng(n).integers(0, 2, (4, n)).astype(np.uint8)
    got = convcode.encode_torch(t(msgs))
    assert got.dtype == torch.uint8 and got.shape == (4, 3, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_convcode.encode_jax(
        jnp.asarray(msgs))))
    for i, m in enumerate(msgs):
        np.testing.assert_array_equal(got.numpy()[i], convcode.encode(m))


# ---------------------------------------------------- segmentation, Gold
@pytest.mark.parametrize("tbs", [152, 1000, 6120, 6144, 20000, 75376])
def test_desegment_and_uniform_k_equal_the_reference(tbs):
    """``test_coding.py::test_segmentation_roundtrip`` on the port, with
    every result held to the reference's."""
    tb = np.random.default_rng(9).integers(0, 2, tbs).astype(np.uint8)
    blocks = segmentation.segment(tb)
    p = segmentation.plan(tbs)
    assert p.uniform_k == ref_seg.plan(tbs).uniform_k == max(p.block_ks)
    back, ok = segmentation.desegment(blocks, tbs)
    ref_back, ref_ok = ref_seg.desegment(blocks, tbs)
    assert ok is ref_ok is True
    np.testing.assert_array_equal(back, tb)
    np.testing.assert_array_equal(back, ref_back)


@pytest.mark.parametrize("tbs, block", [(20000, 1), (1000, 0), (75376, 12)])
def test_desegment_detects_corruption_as_the_reference(tbs, block):
    """``test_coding.py::test_segmentation_detects_corruption`` on the port:
    one flipped bit fails the CRC on both sides."""
    tb = np.random.default_rng(10).integers(0, 2, tbs).astype(np.uint8)
    blocks = segmentation.segment(tb)
    blocks[block] = blocks[block].copy()
    blocks[block][5] ^= 1
    back, ok = segmentation.desegment(blocks, tbs)
    ref_back, ref_ok = ref_seg.desegment(blocks, tbs)
    assert ok is ref_ok is False
    np.testing.assert_array_equal(back, ref_back)


def test_prs_f32_equals_the_reference():
    for c_init, n in ((0, 1), (1, 200), ((0x4601 << 14) + (6 << 9) + 123, 4032)):
        got = seq.prs_f32(c_init, n)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref_seq.prs_f32(c_init, n))
        np.testing.assert_array_equal(got, 1.0 - 2.0 * seq.prs(c_init, n))
