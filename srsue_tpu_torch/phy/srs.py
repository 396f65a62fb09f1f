"""SRS, the sounding reference signal (36.211 5.5.3). The port's own numpy
copy of ``srsue_tpu/phy/srs.py`` (its reference), on the port's
``pusch.dmrs_base_seq``.

A Zadoff-Chu base sequence on a comb (every second subcarrier) in the last
SC-FDMA symbol of the subframe, over the configured bandwidth, with the
cell's and the UE's subframe schedules.
"""

from __future__ import annotations

import numpy as np

from . import pusch
from .cell import Cell

# 36.211 Table 5.5.3.3-1 (FDD): srs-SubframeConfig -> (T_SFC, Delta_SFC set)
SFC_TABLE = [
    (1, {0}), (2, {0}), (2, {1}), (5, {0}), (5, {1}), (5, {2}), (5, {3}),
    (5, {0, 1}), (5, {2, 3}), (10, {0}), (10, {1}), (10, {2}), (10, {3}),
    (10, {0, 1, 2, 3, 4, 6, 8}), (10, {0, 1, 2, 3, 4, 5, 6, 8}), (10, set()),
]

# 36.213 Table 8.2-1: I_SRS -> (first index, periodicity); offset = I_SRS - first
_UE_SRS_PERIODS = ((0, 2), (2, 5), (7, 10), (17, 20), (37, 40), (77, 80), (157, 160),
                   (317, 320), (637, None))


def cell_srs_subframe(config: int, tti: int) -> bool:
    """Does the cell reserve this subframe for SRS?"""
    t, deltas = SFC_TABLE[config]
    return (tti % t) in deltas


def ue_srs_subframe(srs_config_index: int, tti: int) -> bool:
    """Does this UE sound in this subframe?"""
    for (first, t), (nxt, _) in zip(_UE_SRS_PERIODS, _UE_SRS_PERIODS[1:]):
        if srs_config_index < nxt:
            return tti % t == srs_config_index - first
    return False


def generate(cell: Cell, n_prb_srs: int, cyclic_shift: int = 0, comb: int = 0) -> np.ndarray:
    """The frequency-domain SRS of the occupied comb bins over n_prb_srs PRBs:
    [6 * n_prb_srs] complex64 (narrower than 36 bins: the first bins of the
    36-long sequence)."""
    m_sc = 6 * n_prb_srs
    base = pusch.dmrs_base_seq(max(m_sc, 36), cell.cell_id % 30)[:m_sc]
    alpha = 2 * np.pi * cyclic_shift / 8
    return (base * np.exp(1j * alpha * np.arange(m_sc))).astype(np.complex64)


def _bins(cell: Cell, n_prb_srs: int, prb_offset: int, comb: int):
    return cell.n_sym_sf - 1, prb_offset * 12 + comb + 2 * np.arange(6 * n_prb_srs)


def map_to_grid(cell: Cell, grid: np.ndarray, n_prb_srs: int, prb_offset: int = 0,
                cyclic_shift: int = 0, comb: int = 0) -> None:
    """Place the SRS into the last SC-FDMA symbol of a [n_sym_sf, n_sc] grid."""
    sym, ks = _bins(cell, n_prb_srs, prb_offset, comb)
    grid[sym, ks] = generate(cell, n_prb_srs, cyclic_shift, comb)


def detect(cell: Cell, grid: np.ndarray, n_prb_srs: int, prb_offset: int = 0,
           cyclic_shift: int = 0, comb: int = 0) -> float:
    """eNB-side coherent metric (presence, rough channel quality)."""
    seq = generate(cell, n_prb_srs, cyclic_shift, comb)
    sym, ks = _bins(cell, n_prb_srs, prb_offset, comb)
    return float(np.abs(np.vdot(seq, grid[sym, ks])) / max(len(seq), 1))
