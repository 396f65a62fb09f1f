"""Control region for 1 and 2 ports (36.211 6.7/6.8, 36.212 5.1.4.2/5.3.3,
36.213 9.1.1): the REG/CCE geometry, the PCFICH's and PDCCH's scrambling
and the CFI codewords as host tables, the search space, and the host
encoders and mappers of the transmitter. Every control channel maps in REG
quadruplets whose 4 REs stay adjacent in mapping order, so with two ports
the SFBC pairs are (0, 1) and (2, 3) of each quadruplet."""

from __future__ import annotations

import functools
import math

import numpy as np

from . import convcode, crc, modulation, ratematch, regrid, seq
from .cell import Cell
from .precode import alamouti_precode

@functools.lru_cache(maxsize=128)
def regs_in_symbol(cell: Cell, l: int) -> tuple[tuple[int, ...], ...]:
    """REGs of symbol l as tuples of 4 flat RE indices (sym*n_sc + k),
    ordered by frequency. In a symbol with CRS (l = 0, and l = 1 with four
    ports) a REG is the 4 REs of 6 subcarriers off the CRS positions
    k = vshift (mod 3)."""
    n_sc = cell.n_sc
    if l == 0 or (l == 1 and cell.n_ports == 4):
        a = cell.vshift % 6
        return tuple(tuple(l * n_sc + 6 * m + j for j in range(6) if j % 3 != a % 3)
                     for m in range(n_sc // 6))
    return tuple(tuple(l * n_sc + 4 * m + j for j in range(4)) for m in range(n_sc // 4))


@functools.lru_cache(maxsize=128)
def pcfich_regs(cell: Cell) -> tuple[int, ...]:
    """Indices (into regs_in_symbol(cell, 0)) of the 4 PCFICH REGs."""
    n_rb = cell.n_prb
    k_bar = 6 * (cell.cell_id % (2 * n_rb))
    return tuple(((k_bar + (z * n_rb // 2) * 6) % cell.n_sc) // 6 for z in range(4))


def n_phich_groups(cell: Cell) -> int:
    return max(1, math.ceil(cell.phich_resources * cell.n_prb / 8))


@functools.lru_cache(maxsize=128)
def phich_reg_table(cell: Cell) -> tuple[tuple[int, ...], ...]:
    """Per PHICH group: indices into regs_in_symbol(cell, 0) of its 3 REGs
    (normal duration: all in symbol 0). 36.211 6.9.3."""
    pcf = pcfich_regs(cell)
    avail = [i for i in range(len(regs_in_symbol(cell, 0))) if i not in pcf]
    n0 = len(avail)
    return tuple(tuple(avail[(cell.cell_id + m + (i * n0) // 3) % n0] for i in range(3))
                 for m in range(n_phich_groups(cell)))


@functools.lru_cache(maxsize=256)
def pdcch_geometry(cell: Cell, cfi: int):
    """(n_cce, cce_re_idx [n_cce, 36] int32): flat RE indices of each CCE
    after quadruplet interleaving and the cell-ID cyclic shift (36.211
    6.8.5)."""
    used0 = set(pcfich_regs(cell))
    for grp in phich_reg_table(cell):
        used0.update(grp)
    # REGs of the control region in (k, l) order
    reg_list = []
    for l in range(regrid.control_span(cell, cfi)):
        for i, res in enumerate(regs_in_symbol(cell, l)):
            if not (l == 0 and i in used0):
                reg_list.append(((res[0] % cell.n_sc, l), res))
    reg_list.sort(key=lambda t: t[0])
    regs_ordered = [res for _, res in reg_list]
    n_reg = len(regs_ordered)
    n_cce = n_reg // 9

    # quadruplet sub-block interleaver (the conv permutation on indices):
    # REG position i carries interleaved quadruplet perm[(i + cell_id) % n]
    perm = ratematch._interleave_idx(n_reg, ratematch.PERM_CONV)
    perm = perm[perm >= 0]
    reg_of_w = np.empty(n_reg, dtype=np.int64)
    reg_of_w[perm[(np.arange(n_reg) + cell.cell_id) % n_reg]] = np.arange(n_reg)
    cce_re = np.asarray([[re for j in range(9) for re in regs_ordered[reg_of_w[9 * c + j]]]
                         for c in range(n_cce)], dtype=np.int32).reshape(n_cce, 36)
    return n_cce, cce_re


# ---------------------------------------------------------------------------
# PCFICH
# ---------------------------------------------------------------------------

CFI_CW = np.array(
    [
        [0, 1, 1] * 10 + [0, 1],
        [1, 0, 1] * 10 + [1, 0],
        [1, 1, 0] * 10 + [1, 1],
    ],
    dtype=np.uint8,
)  # 36.212 Table 5.3.4-1 (periodic 011/101/110 patterns, 32 bits)


def cfi_scramble(cell: Cell, subframe: int) -> np.ndarray:
    c_init = ((subframe + 1) * (2 * cell.cell_id + 1) << 9) + cell.cell_id
    return seq.prs(c_init, 32)


@functools.lru_cache(maxsize=256)
def pcfich_re(cell: Cell) -> np.ndarray:
    regs = regs_in_symbol(cell, 0)
    return np.asarray([re for r in pcfich_regs(cell) for re in regs[r]], dtype=np.int32)


def pcfich_encode(cell: Cell, subframe: int, cfi: int) -> np.ndarray:
    """The 16 QPSK symbols of the CFI codeword (host)."""
    return modulation.modulate_np(CFI_CW[cfi - 1] ^ cfi_scramble(cell, subframe), 2)


def pcfich_map(cell: Cell, grid: np.ndarray, subframe: int, cfi: int) -> None:
    grid.reshape(-1)[pcfich_re(cell)] = pcfich_encode(cell, subframe, cfi)


def pcfich_map_tm2(cell: Cell, grids, subframe: int, cfi: int) -> None:
    p0, p1 = alamouti_precode(pcfich_encode(cell, subframe, cfi))
    idx = pcfich_re(cell)
    grids[0].reshape(-1)[idx] = p0
    grids[1].reshape(-1)[idx] = p1



# ---------------------------------------------------------------------------
# PDCCH
# ---------------------------------------------------------------------------


def pdcch_scramble(cell: Cell, subframe: int, n_bits: int) -> np.ndarray:
    c_init = (subframe << 9) + cell.cell_id
    return seq.prs(c_init, n_bits)


def pdcch_encode(cell: Cell, subframe: int, dci_bits: np.ndarray, rnti: int,
                 l_aggr: int) -> np.ndarray:
    """DCI payload -> the 72*L coded bits (CRC16 masked by the RNTI,
    tail-biting conv coding, rate matching); scrambling is applied at map
    time, where the CCE offset is known."""
    b = crc.attach(dci_bits, "16", mask=rnti)
    coded = convcode.encode(b)
    return coded.reshape(-1)[ratematch.conv_rm_indices(len(b), 72 * l_aggr)]


def _pdcch_symbols(cell: Cell, subframe: int, cfi: int, dci_bits: np.ndarray, rnti: int,
                   n_cce: int, l_aggr: int):
    """(flat RE indices, QPSK symbols) of one DCI on CCEs n_cce .. n_cce +
    l_aggr - 1 (host)."""
    n_cce_tot, cce_re = pdcch_geometry(cell, cfi)
    bits = pdcch_encode(cell, subframe, dci_bits, rnti, l_aggr)
    scr = pdcch_scramble(cell, subframe, 72 * n_cce_tot)[72 * n_cce: 72 * (n_cce + l_aggr)]
    return cce_re[n_cce: n_cce + l_aggr].reshape(-1), modulation.modulate_np(bits ^ scr, 2)


def pdcch_map(cell: Cell, grid: np.ndarray, subframe: int, cfi: int,
              dci_bits: np.ndarray, rnti: int, n_cce: int, l_aggr: int) -> None:
    """Map one DCI on CCEs n_cce .. n_cce + l_aggr - 1 (host)."""
    res, sym = _pdcch_symbols(cell, subframe, cfi, dci_bits, rnti, n_cce, l_aggr)
    grid.reshape(-1)[res] = sym


def pdcch_map_tm2(cell: Cell, grids, subframe: int, cfi: int, dci_bits: np.ndarray,
                  rnti: int, n_cce: int, l_aggr: int) -> None:
    """The same DCI, SFBC-precoded onto the two ports' grids (host)."""
    res, sym = _pdcch_symbols(cell, subframe, cfi, dci_bits, rnti, n_cce, l_aggr)
    p0, p1 = alamouti_precode(sym)
    grids[0].reshape(-1)[res] = p0
    grids[1].reshape(-1)[res] = p1


def search_space_candidates(n_cce: int, rnti: int, subframe: int,
                            ue_specific: bool = True) -> list[tuple[int, int]]:
    """Candidate (start_cce, L) list: common (L=4,8) then the UE-specific
    hash (36.213 9.1.1), deduplicated in order; the order indexes the
    outputs of ``pdcch_blind_batch``."""
    cands = [(m * l, l) for l, m_max in ((4, 4), (8, 2)) for m in range(m_max)
             if m * l + l <= n_cce]
    if ue_specific and rnti:
        y = rnti
        for _ in range(subframe + 1):
            y = (39827 * y) % 65537
        for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
            if n_cce // l == 0:
                continue
            for m in range(m_max):
                start = l * ((y + m) % (n_cce // l))
                if start + l <= n_cce:
                    cands.append((start, l))
    return list(dict.fromkeys(cands))
