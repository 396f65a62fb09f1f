"""PUCCH formats 1/1a (SR, HARQ-ACK) (36.211 5.4). The port's own numpy
copy of ``srsue_tpu/phy/pucch.py`` (its reference), which keeps PUCCH on
the host; format 2 (CQI) is in ``uci.py``.

Format 1/1a: a length-12 cyclically shifted base sequence, block-spread
over the 4 data symbols of a slot by an orthogonal cover (W_4), with 3
reference symbols per slot, on edge PRBs with slot hopping. Format 1a
BPSK-modulates the ACK bit onto the sequence; format 1 (SR) is on/off. The
eNB-side detector is the round trip's dual.
"""

from __future__ import annotations

import functools

import numpy as np

from . import seq as seqmod
from .cell import Cell

# orthogonal covers of format 1 (normal CP, spreading factor 4 over the data symbols)
W4 = np.array([
    [1, 1, 1, 1],
    [1, -1, 1, -1],
    [1, -1, -1, 1],
], dtype=np.float32)

DATA_SYMS = (0, 1, 5, 6)  # format-1 data symbols of a slot (normal CP)
RS_SYMS = (2, 3, 4)

# 36.211 Table 5.5.1.2-1: phi(n) of the M_sc = 12 base sequences, groups 0..29
_PHI_TABLE = [
    [-1, 1, 3, -3, 3, 3, 1, 1, 3, 1, -3, 3],
    [1, 1, 3, 3, 3, -1, 1, -3, -3, 1, -3, 3],
    [1, 1, -3, -3, -3, -1, -3, -3, 1, -3, 1, -1],
    [-1, 1, 1, 1, 1, -1, -3, -3, 1, -3, 3, -1],
    [-1, 3, 1, -1, 1, -1, -3, -1, 1, -1, 1, 3],
    [1, -3, 3, -1, -1, 1, 1, -1, -1, 3, -3, 1],
    [-1, 3, -3, -3, -3, 3, 1, -1, 3, 3, -3, 1],
    [-3, -1, -1, -1, 1, -3, 3, -1, 1, -3, 3, 1],
    [1, -3, 3, 1, -1, -1, -1, 1, 1, 3, -1, 1],
    [1, -3, -1, 3, 3, -1, -3, 1, 1, 1, 1, 1],
    [-1, 3, -1, 1, 1, -3, -3, -1, -3, -3, 3, -1],
    [3, 1, -1, -1, 3, 3, -3, 1, 3, 1, 3, 3],
    [1, -3, 1, 1, -3, 1, 1, 1, -3, -3, -3, 1],
    [3, 3, -3, 3, -3, 1, 1, 3, -1, -3, 3, 3],
    [-3, 1, -1, -3, -1, 3, 1, 3, 3, 3, -1, 1],
    [3, -1, 1, -3, -1, -1, 1, 1, 3, 1, -1, -3],
    [1, 3, 1, -1, 1, 3, 3, 3, -1, -1, 3, -1],
    [-3, 1, 1, 3, -3, 3, -3, -3, 3, 1, 3, -1],
    [-3, 3, 1, 1, -3, 1, -3, -3, -1, -1, 1, -3],
    [-1, 3, 1, 3, 1, -1, -1, 3, -3, -1, -3, -1],
    [-1, -3, 1, 1, 1, 1, 3, 1, -1, 1, -3, -1],
    [-1, 3, -1, 1, -3, -3, -3, -3, -3, 1, -1, -3],
    [1, 1, -3, -3, -3, -3, -1, 3, -3, 1, -3, 3],
    [1, 1, -1, -3, -1, -3, 1, -1, 1, 3, -1, 1],
    [1, 1, 3, 1, 3, 3, -1, 1, -1, -3, -3, 1],
    [1, -3, 3, 3, 1, 3, 3, 1, -3, -1, -1, 3],
    [1, 3, -3, -3, 3, -3, 1, -1, -1, 3, -1, -3],
    [-3, -1, -3, -1, -3, 3, 1, -1, 1, 3, -3, -3],
    [-1, 3, -3, 3, -1, 3, 3, -3, 3, 3, -1, -1],
    [3, -3, -3, -1, -1, -3, -1, 3, -3, 3, 1, -1],
]


@functools.lru_cache(maxsize=256)
def base_seq12(cell_id: int) -> np.ndarray:
    """Length-12 base sequence r(n) = e^{j phi(n) pi/4} of group u = cell_id
    mod 30."""
    return np.exp(1j * np.pi * np.asarray(_PHI_TABLE[cell_id % 30]) / 4).astype(np.complex64)


def _cyclic_shift_per_symbol(cell: Cell, ns: int, l: int, n_pucch: int) -> float:
    """alpha of (slot ns, symbol l): 8 bits of the cell's Gold sequence
    (a simplified n_cs hopping) plus the resource index."""
    c = seqmod.prs(cell.cell_id, 8 * 2 * 10 * 7 + 8 * (ns * 7 + l) + 8)
    bits = c[8 * (ns * 7 + l):8 * (ns * 7 + l) + 8].astype(np.int64)
    ncs_cell = int((bits << np.arange(7, -1, -1)).sum())
    return 2 * np.pi * ((n_pucch + ncs_cell) % 12) / 12


def pucch_prb(cell: Cell, n_pucch: int, slot: int) -> int:
    """Edge PRB with slot hopping (36.211 5.4.3, simplified to the m = 0
    region)."""
    m = n_pucch // 36
    return m // 2 if (m + slot) % 2 == 0 else cell.n_prb - 1 - m // 2


def _shifted(cell: Cell, subframe: int, slot: int, l: int, n_pucch: int) -> np.ndarray:
    """The base sequence cyclically shifted for symbol l of a slot."""
    alpha = _cyclic_shift_per_symbol(cell, 2 * subframe + slot, l, n_pucch)
    return base_seq12(cell.cell_id) * np.exp(1j * alpha * np.arange(12))


def encode_format1(cell: Cell, subframe: int, n_pucch: int,
                   ack: bool | None = None) -> np.ndarray:
    """Format 1 (SR, ack=None) / 1a (the HARQ-ACK bit): the subframe's
    [n_sym_sf, n_sc] grid contribution, zero elsewhere. d = 1 for a
    positive SR; format 1a: b = 0 (ACK) -> +1."""
    d = 1.0 if ack is None else (1.0 if ack else -1.0)
    grid = np.zeros((cell.n_sym_sf, cell.n_sc), np.complex64)
    oc = W4[n_pucch % 3]
    for slot in range(2):
        sc0 = pucch_prb(cell, n_pucch, slot) * 12
        for i, l in enumerate(DATA_SYMS):
            y = d * oc[i] * _shifted(cell, subframe, slot, l, n_pucch)
            grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12] = y / np.sqrt(12)
        for l in RS_SYMS:
            y = _shifted(cell, subframe, slot, l, n_pucch)
            grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12] = y / np.sqrt(12)
    return grid


def detect_format1(cell: Cell, grid: np.ndarray, subframe: int, n_pucch: int):
    """eNB-side coherent detection: (metric, ack_soft). metric >> 0 says a
    PUCCH is present (SR detection); the sign of ack_soft decodes format
    1a (positive = ACK)."""
    oc = W4[n_pucch % 3]
    acc = rs_acc = 0j
    for slot in range(2):
        sc0 = pucch_prb(cell, n_pucch, slot) * 12
        for i, l in enumerate(DATA_SYMS):
            ref = oc[i] * _shifted(cell, subframe, slot, l, n_pucch)
            acc += np.vdot(ref, grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12])
        for l in RS_SYMS:
            ref = _shifted(cell, subframe, slot, l, n_pucch)
            rs_acc += np.vdot(ref, grid[slot * cell.n_sym_slot + l, sc0:sc0 + 12])
    # coherent demodulation: the data correlation rotated by the RS estimate
    ack_soft = np.real(acc * np.conj(rs_acc))
    metric = (abs(acc) + abs(rs_acc)) / np.sqrt(12)
    return float(metric), float(ack_soft)
