"""PHICH of the torch port (``phy/control.py``) against the JAX reference's:
the REs, symbols and mappings of every group and sequence of a 25 PRB cell
(equal, host numpy), the group/sequence of a PUSCH allocation, and the
decode of ACK and NACK on 1-port grids (ZF-equalized) and 2-port grids
(SFBC, through ``sfbc_equalize_control``). The soft metric agrees within
rtol 1e-5 with a floor of 1e-5 of the largest |metric| (float32 rounding
of the equalizer and the despread); its sign, the decision, is equal and
is the bit that was sent.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsue_tpu.phy import control as ref_control
from srsue_tpu.phy import equalize as ref_eq
from srsue_tpu.phy.cell import Cell
from srsue_tpu_torch.phy import cell as port_cell
from srsue_tpu_torch.phy import control, equalize

B = 2  # subframes, each with its own noise


def _mine(cell):
    return port_cell.Cell(**dataclasses.asdict(cell))


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _channel(rng, cell):
    """A channel that varies slowly over frequency: [n_sym_sf, n_sc]."""
    k = np.arange(cell.n_sc)
    h = (0.8 + 0.4j) + 0.3 * np.exp(2j * np.pi * k / cell.n_sc * rng.uniform(0.5, 2.0))
    return np.broadcast_to(h, (cell.n_sym_sf, cell.n_sc)).astype(np.complex64)


def _acks(group, flip):
    """The ACK bit of each of the group's 8 sequences: a pattern that
    differs between groups, and its complement when `flip`."""
    bits = ((np.arange(8) * 5 + group) % 3 == 0) ^ flip
    return [bool(b) for b in bits]


@pytest.mark.parametrize("cell_id", [301, 42])
def test_phich_tables_match_reference(cell_id):
    for n_prb, ng in ((25, 1.0), (6, 1.0), (100, 0.5), (25, 2.0)):
        cell = Cell(n_prb=n_prb, cell_id=cell_id, phich_resources=ng)
        mine = _mine(cell)
        n_groups = control.n_phich_groups(mine)
        assert n_groups == ref_control.n_phich_groups(cell)
        np.testing.assert_array_equal(control._PHICH_W, ref_control._PHICH_W)
        for group in range(n_groups):
            np.testing.assert_array_equal(control._phich_re(mine, group),
                                          ref_control._phich_re(cell, group))
            for sf in (0, 4, 9):
                for nseq in range(8):
                    for ack in (True, False):
                        np.testing.assert_array_equal(
                            control.phich_symbols(mine, sf, group, nseq, ack),
                            ref_control.phich_symbols(cell, sf, group, nseq, ack))
        for prb in (0, 1, 7, 24, 49, 99):
            for cs in (0, 3, 7):
                assert (control.phich_group_seq(prb, cs, n_groups)
                        == ref_control.phich_group_seq(prb, cs, n_groups))


def _grids(cell, mine, sf, flip):
    """Every group's 8 PHICHs mapped at once, by the port and the reference,
    on 1 port and SFBC on 2 ports."""
    one = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    one_r = one.copy()
    two = [one.copy(), one.copy()]
    two_r = [one.copy(), one.copy()]
    for group in range(control.n_phich_groups(mine)):
        for nseq, ack in enumerate(_acks(group, flip)):
            control.phich_map(mine, one, sf, group, nseq, ack)
            ref_control.phich_map(cell, one_r, sf, group, nseq, ack)
            control.phich_map_tm2(mine, two, sf, group, nseq, ack)
            ref_control.phich_map_tm2(cell, two_r, sf, group, nseq, ack)
    np.testing.assert_array_equal(one, one_r)
    for a, b in zip(two, two_r, strict=True):
        np.testing.assert_array_equal(a, b)
    return one, two


def _check(mine, cell, g_eq, g_eq_r, sf, flip):
    n_groups = control.n_phich_groups(mine)
    got, want = [], []
    for group in range(n_groups):
        for nseq, ack in enumerate(_acks(group, flip)):
            m = control.phich_decode(mine, g_eq, sf, group, nseq, device="cpu")
            m_r = np.asarray(ref_control.phich_decode(cell, g_eq_r, sf, group, nseq))
            assert m.shape == (B,) and m.dtype == torch.float32
            got.append(m.numpy())
            want.append(m_r)
            assert ((m.numpy() > 0) == ack).all(), (group, nseq, ack)
            assert ((m_r > 0) == ack).all()
    got, want = np.stack(got), np.stack(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    return n_groups


@pytest.mark.parametrize("flip", [False, True], ids=["pattern", "complement"])
@pytest.mark.parametrize("n_ports", [1, 2])
def test_phich_ack_nack_every_group_and_sequence(n_ports, flip):
    """25 PRB (4 groups of 8 sequences): every PHICH decodes its bit, as the
    reference does, through a channel and noise at ~20 dB per RE."""
    cell = Cell(n_prb=25, cell_id=301, n_ports=n_ports)
    mine = _mine(cell)
    sf = 3
    rng = np.random.default_rng(10 * n_ports + flip)
    one, two = _grids(cell, mine, sf, flip)
    nv = 0.01
    if n_ports == 1:
        h = _channel(rng, cell)
        y = (h * one + np.sqrt(nv / 2) * _cplx(rng, B, cell.n_sym_sf, cell.n_sc)
             ).astype(np.complex64)
        g_eq, _ = equalize.zf(torch.as_tensor(y), torch.as_tensor(h), nv)
        g_eq_r, _ = ref_eq.zf(jnp.asarray(y), jnp.asarray(h), nv)
    else:
        h0, h1 = _channel(rng, cell), 0.7 * _channel(rng, cell)
        y = (h0 * two[0] + h1 * two[1]
             + np.sqrt(nv / 2) * _cplx(rng, B, cell.n_sym_sf, cell.n_sc)).astype(np.complex64)
        h0b, h1b = (np.broadcast_to(h, y.shape).copy() for h in (h0, h1))
        g_eq, _ = control.sfbc_equalize_control(
            mine, *(torch.as_tensor(a) for a in (y, h0b, h1b)), nv)
        g_eq_r, _ = ref_control.sfbc_equalize_control(
            cell, *(jnp.asarray(a) for a in (y, h0b, h1b)), nv)
    np.testing.assert_allclose(g_eq.numpy(), np.asarray(g_eq_r), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(g_eq_r)).max())
    assert _check(mine, cell, g_eq, g_eq_r, sf, flip) == 4


def test_phich_decode_inputs():
    """A numpy grid goes to the decode's device; one grid gives a scalar
    metric; a grid on another device than the one asked for raises."""
    cell = Cell(n_prb=6, cell_id=17)
    mine = _mine(cell)
    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    control.phich_map(mine, grid, 1, 0, 5, False)
    m = control.phich_decode(mine, grid, 1, 0, 5, device="cpu")
    assert m.shape == () and float(m) < 0
    again = control.phich_decode(mine, torch.as_tensor(grid), 1, 0, 5, device="cpu")
    assert float(again) == float(m)
    m_r = ref_control.phich_decode(cell, jnp.asarray(grid), 1, 0, 5)
    np.testing.assert_allclose(float(m), float(m_r), rtol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            control.phich_decode(mine, grid, 1, 0, 5)
    else:
        with pytest.raises(ValueError, match="PHICH decode asked on"):
            control.phich_decode(mine, torch.as_tensor(grid), 1, 0, 5)
