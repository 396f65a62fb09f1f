"""Resource-grid RE index maps, 36.211 6: CRS positions and values, the
control span and the PDSCH RE enumeration per (cell, subframe, cfi,
allocation).

Host numpy, cached per static configuration; flat indices into
grid[..., n_sym_sf, n_sc] (sym * n_sc + sc), in the spec's mapping order
(subcarrier k first, then symbol l, 36.211 6.3.5).
"""

from __future__ import annotations

import functools

import numpy as np

from . import seq
from .cell import Cell


def _crs_v(port: int, l_in_slot: int) -> int:
    """CRS v parameter (36.211 §6.10.1.2)."""
    if port == 0:
        return 0 if l_in_slot == 0 else 3
    if port == 1:
        return 3 if l_in_slot == 0 else 0
    if port == 2:
        return 3 * 0  # v = 3*(ns mod 2) — handled by caller for ports 2/3
    return 0


@functools.lru_cache(maxsize=128)
def crs_symbols(cell: Cell, port: int) -> tuple[int, ...]:
    """Subframe-symbol indices carrying CRS for a port."""
    ns = cell.n_sym_slot
    if port in (0, 1):
        l_slot = (0, ns - 3)
        return tuple(s * ns + l for s in range(2) for l in l_slot)
    return tuple(s * ns + 1 for s in range(2))  # ports 2/3: l=1 each slot


@functools.lru_cache(maxsize=256)
def crs_positions(cell: Cell, port: int, subframe: int) -> np.ndarray:
    """[n_pilot, 2] array of (symbol, subcarrier) CRS positions for the
    subframe, in mapping order. n_pilot = 2 * n_prb per CRS symbol."""
    out = []
    ns = cell.n_sym_slot
    for sym in crs_symbols(cell, port):
        slot_sym = sym % ns
        slot = sym // ns  # within subframe; absolute ns only matters for seq
        if port in (0, 1):
            v = _crs_v(port, 0 if slot_sym == 0 else 1)
        else:
            abs_ns = 2 * subframe + slot
            v = 3 * (abs_ns % 2) if port == 2 else 3 + 3 * (abs_ns % 2)
        k = 6 * np.arange(2 * cell.n_prb) + (v + cell.vshift) % 6
        for kk in k:
            out.append((sym, kk))
    return np.asarray(out, dtype=np.int32)


@functools.lru_cache(maxsize=256)
def crs_values(cell: Cell, port: int, subframe: int) -> np.ndarray:
    """QPSK CRS symbols r_{l,ns}(m) matched to crs_positions order
    (36.211 §6.10.1.1): c_init = 2^10*(7*(ns+1)+l+1)*(2*cellid+1)
    + 2*cellid + N_cp."""
    n_cp = 0 if cell.extended_cp else 1
    ns_sym = cell.n_sym_slot
    vals = []
    n_max_prb = 110
    for sym in crs_symbols(cell, port):
        slot = sym // ns_sym
        l = sym % ns_sym
        abs_ns = 2 * subframe + slot
        c_init = (
            1024 * (7 * (abs_ns + 1) + l + 1) * (2 * cell.cell_id + 1)
            + 2 * cell.cell_id
            + n_cp
        )
        c = seq.prs(c_init, 4 * n_max_prb)
        r = (1 - 2 * c[0::2].astype(np.float32)) + 1j * (
            1 - 2 * c[1::2].astype(np.float32)
        )
        r = r / np.sqrt(2)
        # center the cell's PRBs inside the 110-PRB numbering
        m = np.arange(2 * cell.n_prb) + (n_max_prb - cell.n_prb)
        vals.append(r[m])
    return np.concatenate(vals).astype(np.complex64)


def control_span(cell: Cell, cfi: int) -> int:
    """OFDM symbols in the control region: CFI, or CFI+1 for narrow cells
    (N_RB <= 10, 36.211 §6.7)."""
    return cfi + 1 if cell.n_prb <= 10 else cfi


def _center72(cell: Cell) -> np.ndarray:
    """Subcarrier indices of the central 6 PRBs (sync/PBCH region)."""
    start = (cell.n_sc - 72) // 2
    return np.arange(start, start + 72)


def pss_symbol(cell: Cell) -> int:
    return cell.n_sym_slot - 1  # last symbol of slot 0


def sss_symbol(cell: Cell) -> int:
    return cell.n_sym_slot - 2


@functools.lru_cache(maxsize=1024)
def pdsch_re(
    cell: Cell, subframe: int, cfi: int, prb_start: int, n_prb_alloc: int
) -> np.ndarray:
    """Flat RE indices (sym * n_sc + sc) of the PDSCH allocation, in
    spec mapping order (k first, then l), excluding:

    * the control region (first `cfi` symbols),
    * CRS REs of all configured ports (both CRS shifts reserved when
      n_ports >= 2),
    * in subframe 0: PBCH region (central 72 sc, slot-1 symbols 0..3),
    * in subframes 0 and 5: PSS/SSS symbols' central 72 subcarriers.
    """
    n_sc = cell.n_sc
    reserved = np.zeros((cell.n_sym_sf, n_sc), dtype=bool)
    reserved[: control_span(cell, cfi), :] = True
    ports = range(max(cell.n_ports, 1))
    for p in ports:
        pos = crs_positions(cell, p, subframe)
        reserved[pos[:, 0], pos[:, 1]] = True
    c72 = _center72(cell)
    if subframe == 0:
        for l in range(4):
            reserved[cell.n_sym_slot + l, c72] = True
    if subframe in (0, 5):
        reserved[sss_symbol(cell), c72] = True
        reserved[pss_symbol(cell), c72] = True

    sc_lo = prb_start * 12
    sc_hi = (prb_start + n_prb_alloc) * 12
    alloc = np.zeros(n_sc, dtype=bool)
    alloc[sc_lo:sc_hi] = True

    idx = []
    for sym in range(control_span(cell, cfi), cell.n_sym_sf):
        ks = np.nonzero(alloc & ~reserved[sym])[0]
        idx.extend(sym * n_sc + ks)
    return np.asarray(idx, dtype=np.int32)
