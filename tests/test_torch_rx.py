"""The port's blind control + data chain (rx.py) against bench.py's: the
same test vectors from the same seed, and the same stats -- TBs passing
CRC, payload bit match, turbo iterations, DCI found, CFI found -- on the
same noisy IQ, for each equalizer and turbo form. The reference's
``early_exit=False`` is the masked contract; the port's ``forced`` form
reports 8 iterations for every block and must agree on everything else."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from srsue_tpu.phy import cell as ref_cell
from srsue_tpu_torch import rx
from srsue_tpu_torch.phy.cell import Cell

STATS = ("n_ok", "bit_match", "mean_iters", "n_dci", "cfi_ok")


def _ref(obj):
    """The reference's Cell or DlGrant with the fields of the port's."""
    return getattr(ref_cell, type(obj).__name__)(**dataclasses.asdict(obj))


def _ref_stats(clean, noisy, early_exit, eq):
    fn = bench.make_rx(_ref(clean.cell), _ref(clean.grant), clean.subframe, clean.cfi, clean.rnti,
                       clean.dci_bits, clean.payloads, early_exit, eq)
    iq_p = np.stack([noisy.real, noisy.imag], -1).astype(np.float32)
    return dict(zip(STATS, np.asarray(jax.jit(fn)(jnp.asarray(iq_p)))[0, :5].tolist()))


def _port_stats(clean, noisy, early_exit, eq, forced=False):
    fn = rx.make_rx(clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
                    clean.dci_bits, early_exit, eq, forced=forced, device="cpu")
    stats = rx.tb_stats(fn(torch.as_tensor(noisy)), clean.payloads, clean.cfi)
    return {k: float(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def small():
    """B=2 subframes at 25 PRB, CFI 2, MCS 1 (TBS 904, one block of K=928)."""
    clean = rx.build_clean(2, cell=Cell(n_prb=25, cell_id=42), mcs=1, cfi=2)
    return clean, rx.add_noise(clean.rng, clean.td, clean.p_sig, 8.0)


@pytest.mark.parametrize("eq", rx.EQS)
def test_make_rx_matches_bench(small, eq):
    clean, noisy = small
    for early_exit in (True, False):
        ref = _ref_stats(clean, noisy, early_exit, eq)
        got = _port_stats(clean, noisy, early_exit, eq)
        assert {k: got[k] for k in STATS} == ref
        assert ref["n_ok"] == ref["n_dci"] == ref["cfi_ok"] == 2 and ref["bit_match"] == 1
    forced = _port_stats(clean, noisy, False, eq, forced=True)
    assert forced["mean_iters"] == forced["max_iters"] == 8
    assert {k: forced[k] for k in STATS if k != "mean_iters"} == {
        k: ref[k] for k in STATS if k != "mean_iters"}


def test_corrupted_control_region_finds_nothing(small):
    clean, noisy = small
    bad = noisy.copy()
    bad[:, : bad.shape[1] // 7] = 0  # the first OFDM symbols: the whole control region
    got = _port_stats(clean, bad, True, "zf")
    assert got["n_dci"] == 0


def test_control_stage_and_bad_equalizer(small):
    clean, noisy = small
    from srsue_tpu_torch.phy import chest, control, dci, ofdm

    grid = ofdm.demodulate(clean.cell, torch.as_tensor(noisy))
    h, nvar, _ = chest.estimate(clean.cell, grid, clean.subframe)
    n = dci.size_0_1a(clean.cell.n_prb)
    cfi, hard, ok = rx.control_stage(clean.cell, clean.subframe, clean.cfi, clean.rnti,
                                     n)(grid, h, nvar)
    n_cce, _ = control.pdcch_geometry(clean.cell, clean.cfi)
    n_cand = len(control.search_space_candidates(n_cce, clean.rnti, clean.subframe))
    assert cfi.tolist() == [2, 2] and hard.shape == (2, n_cand, n) and ok.shape == (2, n_cand)
    with pytest.raises(ValueError, match="eq must be"):
        rx.make_rx(clean.cell, clean.grant, clean.subframe, clean.cfi, clean.rnti,
                   clean.dci_bits, True, "lmmse", device="cpu")


def test_build_clean_matches_bench():
    """The flagship test vectors (100 PRB, MCS 28), host only: the same
    payloads, waveforms, signal power and generator state as bench.py."""
    mine = rx.build_clean(2)
    ref = bench.build_clean(2)
    assert _ref(mine.cell) == ref[0] and _ref(mine.grant) == ref[1]
    assert (mine.subframe, mine.cfi, mine.rnti) == tuple(ref[2:5])
    for a, b in zip((mine.dci_bits, mine.payloads, mine.td), ref[5:8], strict=True):
        np.testing.assert_array_equal(a, b)
    assert mine.p_sig == ref[8]
    assert mine.rng.integers(0, 1 << 30) == ref[9].integers(0, 1 << 30)
    tiled = rx.build_clean(5, n_distinct=2)
    np.testing.assert_array_equal(tiled.payloads[:2], mine.payloads)
    np.testing.assert_array_equal(tiled.payloads[2:4], mine.payloads)
    np.testing.assert_array_equal(tiled.td[4], mine.td[0])


@pytest.mark.slow
def test_flagship_make_rx_matches_bench():
    """100 PRB MCS 28 (13 blocks of K=5824) at B=1, 26 dB, ZF, early exit."""
    clean = rx.build_clean(1)
    noisy = bench.add_noise(clean.rng, clean.td, clean.p_sig, bench.SNR_OPERATING)
    ref = _ref_stats(clean, noisy, True, "zf")
    got = _port_stats(clean, noisy, True, "zf")
    assert {k: got[k] for k in STATS} == ref
    assert ref["n_ok"] == ref["n_dci"] == ref["cfi_ok"] == 1


@pytest.mark.slow
def test_flagship_waterfall_matches_bench():
    """100 PRB MCS 28 at B=2 and 20 dB (the waterfall point), MMSE, early
    exit: the port's stats equal bench.py's on the same noise draw."""
    clean = rx.build_clean(2)
    noisy = bench.add_noise(clean.rng, clean.td, clean.p_sig, 20.0)
    ref = _ref_stats(clean, noisy, True, "mmse")
    assert {k: v for k, v in _port_stats(clean, noisy, True, "mmse").items()
            if k in STATS} == ref
    assert ref["n_dci"] == ref["cfi_ok"] == 2
