"""PBCH / MIB of the torch port (phy/pbch.py) against the JAX reference.

Exact: MIB packing, the 1920-bit codeword, the frame symbols, the RE map,
and every decision of ``decode`` (MIB fields, quarter, port count, the
reject of a wrong cell id) on the same noisy subframe. The deterministic
dematch of one quarter equals the CPU's scatter-add, ``ratematch.dematch``
and the reference bit for bit: all four add the 4 repeats in the order
sent.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import chest as ref_chest
from srsue_tpu.phy import enb_tx as ref_enb_tx
from srsue_tpu.phy import equalize as ref_eq
from srsue_tpu.phy import ofdm as ref_ofdm
from srsue_tpu.phy import pbch as ref_pbch
from srsue_tpu.phy import ratematch as ref_rm
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import chest, equalize, ofdm, pbch, ratematch


def _mine(cell):
    return port_cell.Cell(**dataclasses.asdict(cell))


def _sf0(cell, sfn, snr_db, seed, n_ports=1, gains=(1.0, 1.0)):
    """Noisy subframe 0 with CRS, PSS/SSS and the PBCH of frame `sfn`; each
    port's waveform goes through its flat gain of `gains`."""
    rng = np.random.default_rng(seed)
    grids = [ref_enb_tx.empty_grid(cell) for _ in range(n_ports)]
    for p, grid in enumerate(grids):
        ref_enb_tx.add_crs(cell, grid, 0, p)
    ref_enb_tx.add_sync(cell, grids[0], 0)
    cw = ref_pbch.encode(cell, ref_pbch.Mib(cell.n_prb, "normal", 1.0, sfn), n_ports=n_ports)
    syms = ref_pbch.frame_symbols(cell, cw, sfn % 4)
    if n_ports == 2:
        ref_pbch.map_to_grid_tm2(cell, grids, syms)
    else:
        ref_pbch.map_to_grid(cell, grids[0], syms)
    td = sum(np.complex64(g) * w for g, w in zip(gains, ref_enb_tx.to_waveform(cell, grids)))
    p_sig = float(np.mean(np.abs(td) ** 2)) * cell.nfft / cell.n_sc
    return ref_enb_tx.awgn(rng, td, snr_db, signal_power=p_sig)[0]


def _decode_both(cell, td):
    """(port's, reference's) (mib fields | None, quarter, ports) through
    OFDM demod, port-0 estimate, ZF and ``pbch.decode`` on each side."""
    mine = _mine(cell)
    g = ofdm.demodulate(mine, torch.as_tensor(td))
    h, nvar, _ = chest.estimate(mine, g, 0, port=0)
    got = pbch.decode(mine, *equalize.zf(pbch.extract_re(mine, g), pbch.extract_re(mine, h),
                                         nvar))
    g_r = ref_ofdm.demodulate(cell, jnp.asarray(td))
    h_r, nvar_r, _ = ref_chest.estimate(cell, g_r, 0, port=0)
    ref = ref_pbch.decode(cell, *ref_eq.zf(ref_pbch.extract_re(cell, g_r),
                                           ref_pbch.extract_re(cell, h_r), nvar_r))

    def fields(res):
        return (None if res[0] is None else dataclasses.astuple(res[0]),) + tuple(res[1:])

    return fields(got), fields(ref)


@pytest.mark.parametrize("n_prb,cell_id,n_ports", [(6, 11, 1), (25, 123, 2), (15, 150, 4)])
def test_host_side_matches_reference(n_prb, cell_id, n_ports):
    cell = Cell(n_prb=n_prb, cell_id=cell_id)
    mine = _mine(cell)
    assert (pbch.ANT_MASK, pbch.PRB_CODE) == (ref_pbch.ANT_MASK, ref_pbch.PRB_CODE)
    for sfn, dur, ng in ((0, "normal", 1.0), (1023, "extended", 1 / 6), (517, "normal", 2.0)):
        mib, mib_r = pbch.Mib(n_prb, dur, ng, sfn), ref_pbch.Mib(n_prb, dur, ng, sfn)
        bits = pbch.pack_mib(mib)
        np.testing.assert_array_equal(bits, ref_pbch.pack_mib(mib_r))
        for q in range(4):
            assert (dataclasses.astuple(pbch.unpack_mib(bits, q))
                    == dataclasses.astuple(ref_pbch.unpack_mib(bits, q)))
        cw = pbch.encode(mine, mib, n_ports=n_ports)
        np.testing.assert_array_equal(cw, ref_pbch.encode(cell, mib_r, n_ports=n_ports))
        for q in range(4):
            np.testing.assert_array_equal(pbch.frame_symbols(mine, cw, q),
                                          ref_pbch.frame_symbols(cell, cw, q))
    syms = pbch.frame_symbols(mine, cw, 1)
    grids = [np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64) for _ in range(4)]
    pbch.map_to_grid(mine, grids[0], syms)
    ref_pbch.map_to_grid(cell, grids[1], syms)
    np.testing.assert_array_equal(grids[0], grids[1])
    pbch.map_to_grid_tm2(mine, grids[:2], syms)
    ref_pbch.map_to_grid_tm2(cell, grids[2:], syms)
    np.testing.assert_array_equal(np.stack(grids[:2]), np.stack(grids[2:]))
    g = np.random.default_rng(0).standard_normal((2, cell.n_sym_sf, cell.n_sc, 2)
                                                 ).astype(np.float32).view(np.complex64)[..., 0]
    np.testing.assert_array_equal(pbch.extract_re(mine, torch.as_tensor(g)).numpy(),
                                  np.asarray(ref_pbch.extract_re(cell, jnp.asarray(g))))


def test_deterministic_dematch_equals_scatter_add():
    rng = np.random.default_rng(4)
    llr = (rng.standard_normal((4, pbch.E_FRAME)) * 7).astype(np.float32)
    got = pbch.dematch_quarter(torch.as_tensor(llr)).numpy()
    idx = ratematch.conv_rm_indices(pbch.CODED, pbch.E_TOTAL)
    np.testing.assert_array_equal(idx, ref_rm.conv_rm_indices(pbch.CODED, pbch.E_TOTAL))
    for q in range(4):  # every quarter of the index map is the same 4 repeats
        sl = slice(q * pbch.E_FRAME, (q + 1) * pbch.E_FRAME)
        np.testing.assert_array_equal(idx[sl], np.tile(idx[:120], 4))
        full = np.zeros((4, pbch.E_TOTAL), np.float32)
        full[:, sl] = llr
        np.testing.assert_array_equal(got, torch.zeros(4, 120).index_add_(
            -1, torch.as_tensor(idx), torch.as_tensor(full)).numpy())
        np.testing.assert_array_equal(got, ratematch.dematch(
            torch.as_tensor(full), torch.as_tensor(ratematch.inverse_index(idx, 120))).numpy())
        np.testing.assert_array_equal(got, np.asarray(ref_rm.dematch(
            jnp.asarray(full), idx, 120)))
    assert sorted(idx[:120].tolist()) == list(range(120))


@pytest.mark.parametrize("sfn", [0, 1, 2, 3, 100])
def test_mib_roundtrip_matches_reference(sfn):
    cell = Cell(n_prb=25, cell_id=123)
    got, ref = _decode_both(cell, _sf0(cell, sfn, 10, sfn))
    assert got == ref
    assert got == ((25, "normal", 1.0, sfn), sfn % 4, 1)


def test_low_snr_decisions_match_reference():
    """At -10 dB some seeds decode and some fail: both sides agree on each."""
    cell = Cell(n_prb=6, cell_id=7)
    outcomes = set()
    for seed in range(6):
        got, ref = _decode_both(cell, _sf0(cell, 9, -10, seed))
        assert got == ref
        outcomes.add(got[0] is None)
    assert outcomes == {True, False}


def test_wrong_cell_id_and_empty_region_are_rejected():
    cell = Cell(n_prb=6, cell_id=11)
    td = _sf0(cell, 0, 15, 0)
    got, ref = _decode_both(Cell(n_prb=6, cell_id=12), td)
    assert got == ref == (None, -1, 0)
    # no PBCH energy at all: Viterbi gives the all-zero word, which is rejected
    mine = _mine(cell)
    assert pbch.decode(mine, torch.zeros(240, dtype=torch.complex64), 1.0) == (None, -1, 0)


def test_two_port_block_needs_the_alamouti_hypothesis():
    """SFBC PBCH of a 2-port cell. With equal port gains the single-port
    hypothesis still decodes it (the other port's symbols are interference at
    0 dB, which the rate-1/12 block survives) and the CRC mask says 2 ports.
    With port 0 8 dB under port 1 single-port ZF fails on both sides, and the
    per-port estimates with Alamouti combining recover the MIB under the
    2-port mask, with the reference's decisions."""
    cell = Cell(n_prb=6, cell_id=33, n_ports=2)
    got, ref = _decode_both(cell, _sf0(cell, 10, 12, 5, n_ports=2))
    assert got == ref == ((6, "normal", 1.0, 10), 2, 2)
    td = _sf0(cell, 10, 12, 5, n_ports=2, gains=(0.4, 1.0))
    got, ref = _decode_both(cell, td)
    assert got == ref == (None, -1, 0)
    mine = _mine(cell)
    g = ofdm.demodulate(mine, torch.as_tensor(td))
    h0, nvar, _ = chest.estimate(mine, g, 0, port=0)
    h1, _, _ = chest.estimate(mine, g, 0, port=1)
    x2, nv2 = equalize.alamouti_combine(pbch.extract_re(mine, g), pbch.extract_re(mine, h0),
                                        pbch.extract_re(mine, h1), nvar)
    mib, quarter, ports = pbch.decode(mine, x2, nv2)
    g_r = ref_ofdm.demodulate(cell, jnp.asarray(td))
    h0_r, nvar_r, _ = ref_chest.estimate(cell, g_r, 0, port=0)
    h1_r, _, _ = ref_chest.estimate(cell, g_r, 0, port=1)
    mib_r, quarter_r, ports_r = ref_pbch.decode(cell, *ref_eq.alamouti_combine(
        ref_pbch.extract_re(cell, g_r), ref_pbch.extract_re(cell, h0_r),
        ref_pbch.extract_re(cell, h1_r), nvar_r))
    assert (dataclasses.astuple(mib), quarter, ports) == (
        dataclasses.astuple(mib_r), quarter_r, ports_r) == ((6, "normal", 1.0, 10), 2, 2)
